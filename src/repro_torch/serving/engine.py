"""Host-level serving of the CE-CoLLM system.

Port of ``repro.serving.engine``.  Topology (paper
fig 2/3): N edge clients, each running the edge LLM partition with exits at
l_ee1/l_ee2; one cloud server running the cloud partition behind a
ContentManager.  Per generated token (Algorithm 1):

  1. edge computes layers 1..l_ee2, evaluates both exits, and uploads the
     quantized l_ee1 hidden to the cloud (parallel upload);
  2. if no exit is confident (>= θ), the edge requests cloud inference; the
     cloud pops the uploaded state from the content manager and completes
     layers l_ee1+1..L, returning one token;
  3. the content manager releases unused uploads (paper) or backfills them
     through the cloud partition (beyond-paper exact-KV mode).

Three execution engines implement that contract, as in the JAX package:

  * ``BatchScheduler`` (``ServingSystem.generate``) — the continuous-
    batching engine: a fixed pool of B slots stepped by one batched edge
    step with per-row positions and exit gating, one masked cloud call per
    tick for every below-θ row, finished slots refilled from the queue.
    KV lives in per-slot dense rings (``kv_layout="dense"``) or in a
    block-paged pool shared across slots (``"paged"``; float or int8
    pages, admission back-pressure when pages run out).
  * ``run_multi`` (``ServingSystem.generate_multi``) — the paper's §5
    setting: N single-slot engines (edge clients), each with its own
    channel and virtual clock, driven in lockstep rounds against one
    shared cloud, whose timing is a ``CloudServicePoint`` and whose compute
    is, with ``cloud_batch``, one ``CloudBatcher`` (one masked cloud step
    for the concurrent requests of N clients).
  * ``ServingSystem.generate_sequential`` — one client at a time, batch 1,
    one Python iteration per token: the reference the batched engine is
    held token-identical to.

Cloud requests travel through a ``transport.CloudChannel`` in virtual
time: a reply that misses its deadline loses to the edge's l_ee2 token,
``fallback_after`` misses in a row switch a stream to standalone, and
``overlap=False`` is the blocking baseline.  Samplers: greedy, and
temperature with top-k.  Not ported yet, and refused with the ROADMAP
queue item that ports them: speculative drafting (A.3), preemption, its
schedule and the admission watermark (A.4), chunked prefill and prefix
sharing (A.5), open-loop arrivals, SLOs, adaptive control and resume
pricing (A.6).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.collm import CoLLM, CollmConfig
from repro_torch.core.content_manager import ContentManager
from repro_torch.core.exits import first_confident_exit, select_exit_logits
from repro_torch.core.paging import PagePool, pages_needed
from repro_torch.core.transport import (TOKEN_BYTES, ChannelStats,
                                        CloudChannel, StatePacket,
                                        SyncChannel, hidden_wire_bytes)
from repro_torch.models.transformer import Caches, Model
from repro_torch.serving import sampler as samplerlib
from repro_torch.serving.cloud_batcher import (CloudBatcher, _bucket,
                                               _reset_pages_tree,
                                               _scatter_row,
                                               _scatter_row_paged,
                                               build_upload_ring)


@dataclasses.dataclass
class GenStats:
    tokens: int = 0
    exits_l1: int = 0
    exits_l2: int = 0
    cloud_requests: int = 0       # tokens actually served by a cloud reply
    deadline_misses: int = 0      # replies that missed their deadline
    spec_rewinds: int = 0         # speculative reconciles that disagreed
    fallbacks: int = 0            # switches to standalone fallback
    preemptions: int = 0          # times this stream was checkpointed out
    # multi-token drafting (CollmConfig.spec_k): provisional tokens shipped
    # in verification requests, and how many of them the cloud validated.
    # Both are event counters like deadline_misses — a rewind never unwinds
    # them — so accepted_tokens / draft_tokens is the draft acceptance rate.
    draft_tokens: int = 0         # draft tokens dispatched for verification
    accepted_tokens: int = 0      # draft tokens the cloud reply validated
    # prefix sharing / chunked prefill (CollmConfig.prefix_share /
    # .chunked_prefill): prompt tokens served from shared pages instead of
    # prefill compute, copy-on-write page splits this stream triggered,
    # and page-sized prefill chunk ticks it took to admit
    prefix_hit_tokens: int = 0
    cow_copies: int = 0
    prefill_chunks: int = 0
    upload_bytes: int = 0
    edge_time: float = 0.0
    cloud_time: float = 0.0
    stall_s: float = 0.0          # virtual time stalled on in-flight replies
    overlap_s: float = 0.0        # virtual flight time hidden behind decode
    confidences: List[tuple] = dataclasses.field(default_factory=list)
    # accepted-prefix length of each verified draft reply (0..k); the
    # accept-length histogram of the bench / property tests
    accept_lens: List[int] = dataclasses.field(default_factory=list)
    # fleet replay metrics (docs/fleet_sim.md): per retired stream, the
    # virtual time from its open-loop arrival to its first token, and the
    # virtual gap between consecutive committed tokens (the per-token
    # latency whose p50/p99 the fleet bench gates).  ``slo_total`` counts
    # streams that carried an SLO; ``slo_met`` the ones that met it.
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    token_lat_s: List[float] = dataclasses.field(default_factory=list)
    slo_total: int = 0
    slo_met: int = 0

    @property
    def request_rate(self) -> float:
        """Fraction of emitted tokens served by the cloud.  A
        deadline-missed request commits the edge token, so it counts under
        ``deadline_misses`` (and ``exits_l2``), never as a cloud request;
        zero-token streams have rate 0, not ``cloud_requests / 1``."""
        if self.tokens <= 0:
            return 0.0
        return self.cloud_requests / self.tokens

    def ttft_p(self, q: float) -> float:
        """Time-to-first-token percentile (virtual s), 0 when unmeasured."""
        return float(np.percentile(self.ttft_s, q)) if self.ttft_s else 0.0

    def token_lat_p(self, q: float) -> float:
        """Inter-token latency percentile (virtual s), 0 when unmeasured."""
        return (float(np.percentile(self.token_lat_s, q))
                if self.token_lat_s else 0.0)

    @property
    def slo_attainment(self) -> float:
        """Fraction of SLO-carrying streams that met every armed target
        (vacuously 1.0 when no stream carried an SLO)."""
        return self.slo_met / self.slo_total if self.slo_total else 1.0

    @property
    def preemption_rate(self) -> float:
        return self.preemptions / self.tokens if self.tokens else 0.0

    @property
    def deadline_miss_rate(self) -> float:
        return self.deadline_misses / self.tokens if self.tokens else 0.0


def _aggregate(stats: Sequence[Optional[GenStats]]) -> GenStats:
    """Field-generic aggregation (scalars sum, lists concatenate); ``None``
    entries are skipped."""
    agg = GenStats()
    for st in stats:
        if st is None:
            continue
        for f in dataclasses.fields(GenStats):
            v = getattr(st, f.name)
            if isinstance(v, list):
                getattr(agg, f.name).extend(v)
            else:
                setattr(agg, f.name, getattr(agg, f.name) + v)
    return agg


class CloudServer:
    """Cloud partition + content manager (one per deployment).

    ``request`` pops the uploaded state(s), runs the cloud partition step
    and submits the logits, still on the device, into the caller's
    channel."""

    def __init__(self, collm: CoLLM, max_clients_pending: int = 8):
        self.collm = collm
        self.cm = ContentManager(max_pending_per_client=max_clients_pending)

    def register(self, device_id: str, batch: int, max_seq: int,
                 h1_prompt: Optional[torch.Tensor] = None):
        caches = self.collm.init_cloud_cache(batch, max_seq)
        logits = None
        if h1_prompt is not None:
            logits, caches = self.collm.cloud_prefill(h1_prompt, caches)
        self.cm.put_cache(device_id, caches)
        return logits

    def receive_upload(self, device_id: str, pos: int,
                       packet: StatePacket) -> None:
        self.cm.upload(device_id, pos, packet)

    def request(self, channel: CloudChannel, device_id: str, pos: int, *,
                now: float = 0.0, backfill: bool = False, slot: int = 0,
                seq: int = 0) -> int:
        """Dispatch one single-token cloud inference (paper §4.2) into
        ``channel``; returns the in-flight handle.

        Wire accounting: the hidden-state packets this request consumes
        (one, or the whole pending ring under ``backfill``) were billed
        once, at upload time; the request itself is a token-sized control
        message."""
        caches = self.cm.get_cache(device_id)
        if backfill:
            pending = self.cm.take_uploads_upto(device_id, pos)
        else:
            pending = [(pos, self.cm.take_upload(device_id, pos))]
        logits = None
        for p, pkt in pending:
            logits, caches = self.collm.cloud_step(pkt.hidden, caches, p)
        self.cm.put_cache(device_id, caches)
        return channel.submit(slot=slot, seq=seq, pos=pos, reply=logits,
                              now=now, nbytes_up=TOKEN_BYTES,
                              nbytes_down=TOKEN_BYTES)

    def finish(self, device_id: str) -> None:
        self.cm.end_of_sequence(device_id)


class EdgeClient:
    """Edge partition runtime for one device."""

    def __init__(self, collm: CoLLM, device_id: str, batch: int,
                 max_seq: int):
        self.collm = collm
        self.device_id = device_id
        self.caches: Caches = collm.init_edge_cache(batch, max_seq)
        self.pos = 0

    def prefill(self, batch: Dict[str, torch.Tensor]):
        decisions, h1_seq, self.caches = self.collm.edge_prefill(
            batch, self.caches)
        self.pos = h1_seq.shape[1]
        return decisions, h1_seq

    def step(self, token: torch.Tensor):
        out = self.collm.edge_step(token, self.caches, self.pos)
        self.caches = out.caches
        self.pos += 1
        return out


# ---------------------------------------------------------------------------
# continuous-batching engine
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Request:
    """One client stream queued for the scheduler.  ``arrival_t`` is its
    virtual arrival: the scheduler's clock when the run started (open-loop
    arrivals and SLO targets are not ported yet, ROADMAP A.6)."""
    device_id: str
    prompt: np.ndarray
    max_new: int
    eos_id: Optional[int] = None
    index: int = 0                   # submission order (result slot)
    arrival_t: float = 0.0


@dataclasses.dataclass
class _Pending:
    """One in-flight cloud request of a slot."""
    pos: int                 # decode position the request serves
    tok_index: int           # index in slot.tokens its token lands at
    provisional: int         # edge l_ee2 token committed on deadline miss
    stall_from: float        # virtual submit time
    deadline_t: float
    idle_at: float = 0.0     # engine idle integral at submit (overlap_s)


@dataclasses.dataclass
class _Slot:
    """One row of the batched pool.  Lifecycle:
    FREE -> (admit: prefill + scatter row caches) ACTIVE
         -> (decode ticks) ... -> (EOS / max_new) FINISHED -> FREE.

    ``seq`` is the slot *generation*: it increments at every admission, so
    a cloud reply issued by a retired stream can never be applied to the
    slot's successor.  ``pending`` holds the in-flight cloud request (at
    most one: the row stalls until it resolves).  ``miss_streak`` counts
    deadline misses in a row; ``standalone`` is the latency fallback (the
    row stops uploading and serves itself)."""
    index: int
    req: Optional[Request] = None
    stats: Optional[GenStats] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    # virtual commit time of each entry of ``tokens``
    emit_ts: List[float] = dataclasses.field(default_factory=list)
    pos: int = 0
    last_token: int = 0
    active: bool = False
    seq: int = 0
    pending: Dict[int, _Pending] = dataclasses.field(default_factory=dict)
    miss_streak: int = 0
    standalone: bool = False


class BatchScheduler:
    """Continuous-batching multi-slot decode engine.

    B client streams advance together under one batched edge step with
    per-row positions; exits are gated per row; one masked cloud call
    serves all below-θ rows of a tick; finished slots are refilled from
    the queue.  KV lives in per-slot dense rings (``kv_layout="dense"``)
    or in a block-paged pool shared across slots (``"paged"``, float or
    int8 pages): admission allocates the prompt's pages and waits while
    the pool cannot cover a request's worst case (conservative
    back-pressure), each decode tick allocates a page only when a row
    crosses a page boundary, and retirement frees the slot's pages and
    invalidates them on the card.  The block table lives on the host
    (``PagePool.block_table``); its device copy is rebuilt only after an
    alloc or free changed it, and is shared by every layer of a step.

    Each tick is the JAX engine's two-stage pipeline:

      1. the edge pass over every row (rows stalled on an in-flight reply,
         and idle slots, flow through as placeholders whose outputs are
         dropped and whose paged writes land on the trash page);
      2. one dispatch of this tick's below-θ rows: one masked cloud call
         computes them all (or, with a shared ``CloudBatcher``, they queue
         there to join other engines' rows in one wave), and the logits
         enter ``channel`` per row, still on the device, while the engine
         keeps decoding.

    Replies drain against a per-row deadline in virtual time: a miss
    commits the row's edge l_ee2 token (the paper's latency-aware early
    exit), a reply that arrived after its deadline is dropped, and
    ``fallback_after`` consecutive misses flip the row to standalone.
    When every active row waits on the channel, the clock jumps to the
    next arrival or deadline.  ``overlap=False`` degrades stage 2 to a
    blocking drain (the whole pool waits).  The default ``SyncChannel``
    (zero latency) is the blocking engine, token for token.  Samplers
    other than greedy draw from a ``torch.Generator`` seeded with
    ``seed`` on the model's device.  Refused with their ROADMAP item:
    preemption's schedule and the watermark (A.4), adaptive control and
    resume pricing (A.6)."""

    def __init__(self, collm: CoLLM, cm: ContentManager, num_slots: int,
                 max_seq: int, mode: str = "collm", sampler: str = "greedy",
                 temperature: float = 1.0, top_k: int = 0, seed: int = 0,
                 max_ctx: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 channel: Optional[CloudChannel] = None,
                 tick_time_s: float = 0.0, overlap: bool = True,
                 fallback_after: int = 0,
                 cloud_batcher: Optional[CloudBatcher] = None,
                 watermark: int = 0, preempt_schedule: Any = None,
                 adaptive: Any = None, resume_cost: Any = None):
        if mode not in ("collm", "standalone", "cloud"):
            raise ValueError(mode)
        refused = {"watermark": (watermark != 0, "A.4"),
                   "preempt_schedule": (bool(preempt_schedule), "A.4"),
                   "adaptive": (adaptive is not None, "A.6"),
                   "resume_cost": (resume_cost is not None, "A.6")}
        _refuse("BatchScheduler options", refused)
        # cloud compute delegated to a shared CloudBatcher (multi-engine
        # mode): this engine then keeps no cloud caches of its own
        self._batcher = cloud_batcher if mode == "collm" else None
        self.collm = collm
        self.model = collm.model
        self.ccfg = collm.ccfg
        self.cm = cm
        self.B = num_slots
        self.max_seq = max_seq
        self.mode = mode
        self.sampler = sampler
        self.temperature = temperature
        self.top_k = top_k
        self._gen = torch.Generator(device=self.model.device)
        self._gen.manual_seed(seed)
        self.slots = [_Slot(index=i) for i in range(num_slots)]

        # cloud channel + virtual clock
        self.channel = channel if channel is not None else SyncChannel()
        self.tick_time_s = float(tick_time_s)
        self.overlap = bool(overlap)
        self.fallback_after = int(fallback_after)
        self.vnow = 0.0
        self.last_virtual_time = 0.0
        self.late_drops = 0          # replies dropped after slot moved on
        self._idle_s = 0.0           # virtual time nobody decoded (waits)

        self.layout = self.ccfg.kv_layout
        if self.layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout {self.layout!r}")
        self.pool: Optional[PagePool] = None
        self._tbl_device: Optional[torch.Tensor] = None  # cached device table
        if self.layout == "paged":
            ps = self.ccfg.page_size
            self.max_ctx = max_ctx or max_seq
            n_pages = num_pages or num_slots * pages_needed(max_seq, ps)
            self.pool = PagePool(n_pages, ps, num_slots,
                                 pages_needed(self.max_ctx, ps))
            row_seq = _bucket(self.max_ctx)
        else:
            self.max_ctx = max_seq
            row_seq = max_seq
        self._row_seq = row_seq        # single-row prefill cache capacity

        # pooled caches, and one single-row prefill cache per partition
        # that every admission reuses (a prefill rewrites slots [0, pad)
        # and invalidates everything from the true length on)
        if mode == "cloud":
            self.main_caches = self._init_pool_cache(
                self.model.init_cache,
                lambda b, n, ps: self.model.init_paged_cache(
                    n, ps, kv_dtype=self.ccfg.kv_dtype))
            self._full_row0 = self.model.init_cache(1, row_seq)
        else:
            self.edge_caches = self._init_pool_cache(
                collm.init_edge_cache, collm.init_edge_cache_paged)
            self._edge_row0 = collm.init_edge_cache(1, row_seq)
            if mode == "collm" and self._batcher is None:
                self.cloud_caches = self._init_pool_cache(
                    collm.init_cloud_cache, collm.init_cloud_cache_paged)
                self._cloud_row0 = collm.init_cloud_cache(1, row_seq)

    def _init_pool_cache(self, dense_init, paged_init):
        if self.layout == "paged":
            return paged_init(self.B, self.pool.num_pages,
                              self.pool.page_size)
        return dense_init(self.B, self.max_seq)

    def _trees(self) -> List[Caches]:
        return [getattr(self, n) for n in
                ("main_caches", "edge_caches", "cloud_caches")
                if getattr(self, n, None) is not None]

    def kv_cache_bytes(self) -> int:
        """Device bytes held by the pooled KV caches (the number the paged
        layout shrinks: num_pages x page_size instead of B x max_seq)."""
        return sum(leaf.numel() * leaf.element_size()
                   for tree in self._trees() for layers in tree.values()
                   for c in layers for leaf in c["self"].values())

    def _block_tbl(self) -> Optional[torch.Tensor]:
        """Device copy of the pool's block table, uploaded again only after
        an alloc/free actually changed it (most ticks change nothing)."""
        if self.pool is None:
            return None
        if self._tbl_device is None:
            self._tbl_device = torch.tensor(self.pool.block_table,
                                            device=self.model.device)
        return self._tbl_device

    # -- sampling -----------------------------------------------------------
    def _pick(self, logits: torch.Tensor) -> np.ndarray:
        """logits (B, V) -> tokens (B,) on the host under the configured
        sampler."""
        return samplerlib.sample(
            logits, method=self.sampler, gen=self._gen,
            temperature=self.temperature, top_k=self.top_k).cpu().numpy()

    # -- admission ----------------------------------------------------------
    def _outstanding_pages(self) -> int:
        """Worst-case pages still owed to the active streams, so that an
        admitted stream can always finish."""
        out = 0
        for s in self.slots:
            if not s.active or s.req is None:
                continue
            worst = pages_needed(len(s.req.prompt) + s.req.max_new,
                                 self.pool.page_size)
            out += max(0, worst - self.pool.owned_pages(s.index))
        return out

    def _admissible(self, req: Request, p_len: int, pad: int) -> bool:
        """Capacity check.  Impossible requests raise; a request the paged
        pool could serve but not *right now* stays queued (back-pressure).
        The check is the conservative worst case, so a decode-time alloc
        can never fail."""
        if p_len + req.max_new > self.max_ctx or pad > self._row_seq:
            raise ValueError(
                f"request {req.device_id}: prompt {p_len} + max_new "
                f"{req.max_new} exceeds max context {self.max_ctx}")
        if self._batcher is not None \
                and not self._batcher.can_admit(p_len + req.max_new):
            return False        # shared cloud pool full: wait for a release
        if self.pool is None:
            return True
        need_worst = pages_needed(p_len + req.max_new, self.pool.page_size)
        if need_worst > self.pool.num_pages:
            raise ValueError(
                f"request {req.device_id}: needs {need_worst} pages but the "
                f"pool only has {self.pool.num_pages}")
        return need_worst <= (self.pool.free_pages
                              - self._outstanding_pages())

    def _reset_freed(self, freed: List[int]) -> None:
        """Invalidate freed physical pages (pos = -1) on every cache tree
        this engine holds, so reallocation can never leak their K/V."""
        if not freed:
            return
        for tree in self._trees():
            _reset_pages_tree(tree, freed)

    def _alloc_page(self, idx: int, lp: int) -> None:
        self.pool.alloc(idx, lp)
        self._tbl_device = None

    def _admit_pages(self, slot: _Slot, p_len: int, pad: int) -> np.ndarray:
        """Allocate the prompt's pages now (later pages are alloc-on-write)
        and return the scatter table (one physical id per logical bucket
        page; -1 = trash for bucket padding past the prompt)."""
        pool = self.pool
        n_prompt = pages_needed(p_len, pool.page_size)
        for lp in range(n_prompt):
            self._alloc_page(slot.index, lp)
        pages = np.full((pages_needed(pad, pool.page_size),), -1, np.int32)
        pages[:n_prompt] = pool.block_table[slot.index, :n_prompt]
        return pages

    def _scatter_admit(self, full: Caches, row: Caches, slot: _Slot,
                       pages: Optional[np.ndarray]) -> Caches:
        if pages is None:
            return _scatter_row(full, row, slot.index)
        return _scatter_row_paged(full, row, slot.index, pages)

    def _admit(self, queue) -> bool:
        admitted = False
        dev = self.model.device
        for slot in self.slots:
            if slot.active or slot.req is not None or not queue:
                # a finished-but-uncollected slot keeps its req until
                # _collect copies the results out — never reuse it here
                continue
            req: Request = queue[0]
            prompt = np.asarray(req.prompt, np.int32)
            p_len = len(prompt)
            # right-padded prefill is exact: every ported block is
            # attention, where pads are causally invisible to real tokens
            pad = _bucket(p_len)
            if not self._admissible(req, p_len, pad):
                break                       # FIFO back-pressure: wait for pages
            queue.popleft()
            pages = (self._admit_pages(slot, p_len, pad)
                     if self.pool is not None else None)
            tokens = torch.zeros((1, pad), dtype=torch.long, device=dev)
            tokens[0, :p_len] = torch.as_tensor(prompt, device=dev)
            st = GenStats()
            if self.mode == "cloud":
                t0 = time.perf_counter()
                logits, row = self.collm.full_prefill_padded(
                    tokens, p_len, self._full_row0)
                self.main_caches = self._scatter_admit(self.main_caches, row,
                                                       slot, pages)
                tok = int(self._pick(logits[:, 0])[0])
                st.cloud_time += time.perf_counter() - t0
            else:
                t0 = time.perf_counter()
                decisions, h1_seq, row = self.collm.edge_prefill_padded(
                    tokens, p_len, self._edge_row0,
                    with_logits=self.sampler != "greedy")
                self.edge_caches = self._scatter_admit(self.edge_caches, row,
                                                       slot, pages)
                fetched = {l: (int(d.token[0]), float(d.confidence[0]),
                               d.logits)
                           for l, d in decisions.items()}
                st.edge_time += time.perf_counter() - t0

                prefill_logits = None
                if self.mode == "collm":
                    t0 = time.perf_counter()
                    if self._batcher is not None:
                        logits = self._batcher.admit(
                            req.device_id, h1_seq, p_len,
                            p_len + req.max_new)
                    else:
                        logits, crow = self.collm.cloud_prefill_padded(
                            h1_seq, p_len, self._cloud_row0)
                        self.cloud_caches = self._scatter_admit(
                            self.cloud_caches, crow, slot, pages)
                    prefill_logits = logits[:, 0]
                    st.cloud_time += time.perf_counter() - t0
                    st.upload_bytes += hidden_wire_bytes(
                        self.model.cfg.d_model, self.ccfg.wire_format,
                        seq=p_len)
                tok = self._first_token(fetched, prefill_logits, st)
            st.tokens = 1
            slot.req, slot.stats = req, st
            slot.tokens = [tok]
            slot.emit_ts = [self.vnow]
            slot.last_token = tok
            slot.pos = p_len
            slot.active = True
            slot.seq += 1            # late replies of the predecessor drop
            slot.pending = {}
            slot.miss_streak = 0
            slot.standalone = False
            admitted = True
            self._maybe_finish(slot)
        return admitted

    def _first_token(self, fetched: Dict, prefill_logits, st: GenStats) -> int:
        """First token from the prompt's last position — same decision tree
        as the sequential path."""
        layers = sorted(fetched)
        greedy = self.sampler == "greedy"
        if self.mode == "standalone":
            tok_l, _, logits_l = fetched[layers[-1]]
            return tok_l if greedy else int(self._pick(logits_l)[0])
        for l in layers:
            tok_l, conf_l, logits_l = fetched[l]
            if conf_l >= self.ccfg.theta:
                return tok_l if greedy else int(self._pick(logits_l)[0])
        # cloud already prefilled through the prompt: its last-position
        # logits ARE the cloud answer for the first token
        st.cloud_requests += 1
        return int(self._pick(prefill_logits)[0])

    def _finalize_latency(self, slot: _Slot) -> None:
        """Fold the stream's per-token emission timestamps (virtual time)
        into its stats at retirement: TTFT and inter-token gaps."""
        ts = slot.emit_ts
        if not ts:
            return
        slot.stats.ttft_s.append(ts[0] - slot.req.arrival_t)
        slot.stats.token_lat_s.extend(b - a for a, b in zip(ts, ts[1:]))

    # -- slot retirement ----------------------------------------------------
    def _maybe_finish(self, slot: _Slot) -> bool:
        req = slot.req
        done = (len(slot.tokens) >= req.max_new
                or (req.eos_id is not None
                    and slot.tokens[-1] == req.eos_id))
        done = done and not slot.pending
        if done:
            self._finalize_latency(slot)
            if self.mode == "collm":
                if self._batcher is not None:
                    # cancels queued requests, frees the cloud pool row
                    self._batcher.release(req.device_id)
                self.cm.end_of_sequence(req.device_id)
            slot.active = False
            if self.pool is not None:
                self._free_pages(slot)
        return done

    def _runnable(self, s: _Slot) -> bool:
        """A slot decodes this tick unless it is stalled on an in-flight
        cloud reply."""
        if not s.active or s.pending:
            return False
        if len(s.tokens) >= s.req.max_new:
            return False
        if (s.req.eos_id is not None and s.tokens
                and s.tokens[-1] == s.req.eos_id):
            return False
        return True

    def _free_pages(self, slot: _Slot) -> None:
        """Bulk-free a retired slot's pages and invalidate them on device
        (pos = -1) so reallocation can never leak its K/V."""
        freed = self.pool.free_slot(slot.index)
        self._tbl_device = None
        self._reset_freed(freed)

    # -- one decode tick ----------------------------------------------------
    def tick(self) -> None:
        """One step of the two-stage pipeline: resolve due replies, run the
        edge pass for every row, dispatch this tick's below-θ cloud
        requests, resolve again (a ``SyncChannel`` reply arrives within
        the same tick).  When every active row waits on the channel, the
        virtual clock jumps to the next arrival or deadline instead."""
        self._resolve()
        runnable = [s for s in self.slots if self._runnable(s)]
        if not runnable:
            if any(s.active for s in self.slots):
                self._advance_idle()
                self._resolve()
            return
        if self.pool is not None:
            for s in runnable:
                # alloc-on-write: this tick writes KV at s.pos
                lp = s.pos // self.pool.page_size
                if self.pool.block_table[s.index, lp] == -1:
                    self._alloc_page(s.index, lp)
        tokens = np.zeros((self.B, 1), np.int64)
        pos = np.zeros((self.B,), np.int32)
        for s in self.slots:
            if s.active:     # stalled rows: placeholder decode, outputs dropped
                tokens[s.index, 0] = s.last_token
                pos[s.index] = s.pos
        dev = self.model.device
        tokens = torch.as_tensor(tokens, device=dev)
        pos_t = torch.as_tensor(pos, device=dev)

        self.vnow += self.tick_time_s    # this tick's edge compute (virtual)
        if self.mode == "cloud":
            self._tick_cloud(runnable, tokens, pos_t)
        else:
            self._tick_edge(runnable, tokens, pos_t)

        for s in runnable:
            s.pos += 1
            self._maybe_finish(s)
        self._resolve()

    def _tick_cloud(self, runnable, tokens, pos) -> None:
        t0 = time.perf_counter()
        tok, logits, self.main_caches = self.collm.full_step(
            tokens, self.main_caches, pos, self._block_tbl())
        if self.sampler == "greedy":
            next_tok = tok.cpu().numpy()
        else:
            next_tok = self._pick(logits)
        dt = (time.perf_counter() - t0) / len(runnable)
        for s in runnable:
            s.stats.cloud_time += dt
            self._emit(s, int(next_tok[s.index]))

    def _tick_edge(self, runnable, tokens, pos) -> None:
        collm, ccfg = self.collm, self.ccfg
        greedy = self.sampler == "greedy"
        t0 = time.perf_counter()
        out = collm.edge_step(tokens, self.edge_caches, pos, self._block_tbl(),
                              with_logits=not greedy)
        self.edge_caches = out.caches
        # one device->host copy per tick: exit token, exit flag, the l_ee2
        # token and every exit's confidence (float64 holds all exactly)
        layers = sorted(out.decisions)
        host = torch.stack(
            [out.token.double(), out.exited.double(),
             out.decisions[collm.l_ee2].token.double()]
            + [out.decisions[l].confidence.double() for l in layers]
        ).cpu().numpy()
        exit_toks = host[0].astype(np.int64)
        exited = host[1] > 0
        tok2 = host[2].astype(np.int64)
        confs = dict(zip(layers, host[3:]))
        if not greedy:
            # the sampling path draws from the chosen exit's logits; rows
            # that exit nowhere get the LAST exit's logits, which is also
            # what a deadline miss or a standalone row commits
            if self.mode == "standalone":
                sel = out.decisions[collm.l_ee2].logits
            else:
                sel = select_exit_logits(out.decisions, ccfg.theta)[0]
            exit_toks = tok2 = self._pick(sel)
        edge_dt = (time.perf_counter() - t0) / len(runnable)

        for s in runnable:
            s.stats.edge_time += edge_dt
            s.stats.tokens += 1
            c1 = float(confs.get(collm.l_ee1, np.zeros(self.B))[s.index])
            c2 = float(confs.get(collm.l_ee2, np.zeros(self.B))[s.index])
            s.stats.confidences.append((c1, c2))

        if self.mode == "standalone":
            for s in runnable:
                if s.stats.confidences[-1][0] >= ccfg.theta:
                    s.stats.exits_l1 += 1
                else:
                    s.stats.exits_l2 += 1
                self._emit(s, int(tok2[s.index]))
            return

        # parallel upload (always dispatched at l_ee1) — batched receive.
        # Standalone-fallback rows have given up on the cloud: no upload.
        up = out.upload
        uploaders = [s for s in runnable if not s.standalone]
        pkts = {s.index: StatePacket(
            hidden={k: v[s.index:s.index + 1] for k, v in up.items()},
            pos=s.pos) for s in uploaders}
        self.cm.upload_batch((s.req.device_id, s.pos, pkts[s.index])
                             for s in uploaders)
        for s in uploaders:
            nb = pkts[s.index].nbytes()
            s.stats.upload_bytes += nb
            self.channel.notify_upload(s.index, nb, self.vnow)

        # ``tok2`` is the provisional token a deadline miss commits
        needy = [s for s in uploaders if not exited[s.index]]
        if needy:
            self._dispatch_cloud(needy, pos, tok2)
        for s in runnable:
            if exited[s.index]:
                if s.stats.confidences[-1][0] >= ccfg.theta:
                    s.stats.exits_l1 += 1
                else:
                    s.stats.exits_l2 += 1
                self._emit(s, int(exit_toks[s.index]))
            elif s.standalone:
                # latency fallback: the edge serves its below-θ tokens
                s.stats.exits_l2 += 1
                self._emit(s, int(tok2[s.index]))
            # else: needy — token arrives via the channel (_resolve)

    def _dispatch_cloud(self, needy: List[_Slot], pos: torch.Tensor,
                        prov_toks: np.ndarray) -> None:
        """Stage 2: one masked cloud call computes every below-θ slot of
        the tick (with backfill, the ring of each row's pending uploads);
        per-row requests enter the channel and the engine keeps decoding
        while they are in flight.  The logits stay on the card until the
        drain materializes them.  With a shared ``CloudBatcher`` the masked
        call itself is deferred too: the requests queue with the batcher so
        that other engines' concurrent rows join the same wave."""
        ccfg = self.ccfg
        dev = self.model.device
        t0 = time.perf_counter()
        if self._batcher is not None:
            payloads = {}
            for s in needy:
                group, row, _ = self._batcher.submit(
                    s.req.device_id, s.pos, backfill=ccfg.backfill)
                payloads[s.index] = (group, row)
        else:
            if ccfg.backfill:
                rings = self.cm.take_uploads_upto_batch(
                    [(s.req.device_id, s.pos) for s in needy])
                ring, ring_pos, valid = build_upload_ring(
                    [(s.index, pend) for s, pend in zip(needy, rings)],
                    self.B)
                logits, self.cloud_caches = self.collm.ring_cloud_steps(
                    ring, ring_pos, valid, self.cloud_caches,
                    self._block_tbl())
            else:
                pkts = self.cm.take_upload_batch(
                    [(s.req.device_id, s.pos) for s in needy])
                rows = torch.as_tensor([s.index for s in needy], device=dev)
                dense = {}
                for k, v in pkts[0].hidden.items():
                    dense[k] = torch.zeros((self.B,) + tuple(v.shape[1:]),
                                           dtype=v.dtype, device=dev)
                    dense[k][rows] = torch.cat([p.hidden[k] for p in pkts])
                mask = torch.zeros((self.B,), dtype=torch.bool, device=dev)
                mask[rows] = True
                logits, self.cloud_caches = self.collm.cloud_step(
                    dense, self.cloud_caches, pos,
                    block_tbl=self._block_tbl(), write_mask=mask)
            group = {"logits": logits, "np": None}   # materialized at drain
            payloads = {s.index: (group, s.index) for s in needy}

        dt = (time.perf_counter() - t0) / len(needy)
        handles = []
        for s in needy:
            s.stats.cloud_time += dt
            h = self.channel.submit(
                slot=s.index, seq=s.seq, pos=s.pos, reply=payloads[s.index],
                now=self.vnow, nbytes_up=TOKEN_BYTES, nbytes_down=TOKEN_BYTES)
            s.pending[h] = _Pending(
                pos=s.pos, tok_index=len(s.tokens),
                provisional=int(prov_toks[s.index]), stall_from=self.vnow,
                deadline_t=self.vnow + self.channel.deadline_s,
                idle_at=self._idle_s)
            handles.append(h)
        if not self.overlap:
            # blocking baseline: the whole pool waits for this tick's
            # replies (still paying the channel's virtual latency); the
            # jump is pure idle time, nothing decodes during it
            arr = [self.channel.arrival_of(h) for h in handles]
            target = max([self.vnow] + [a for a in arr if a is not None])
            self._idle_s += target - self.vnow
            self.vnow = target

    # -- reply drain --------------------------------------------------------
    def _reply_token(self, rep) -> int:
        """Materialize a reply group's tokens (once per dispatched batch)
        and return this row's."""
        group, row = rep.reply
        if group["np"] is None:
            if group["logits"] is None:
                # CloudBatcher reply: the batched cloud step is lazy so
                # that concurrent engines' requests land in one wave; the
                # first materialization computes it
                group["flush"]()
            group["np"] = self._pick(group["logits"])
        return int(group["np"][row])

    def _hidden_s(self, pend: _Pending) -> float:
        """Virtual time of this request's wait that was hidden behind the
        pool's continued decoding: the stalled window minus the part of it
        the whole engine spent idle (``_advance_idle`` jumps and the
        blocking drain).  At 1 slot, or with ``overlap=False``, every wait
        is idle and it stays 0."""
        stall = self.vnow - pend.stall_from
        idle = self._idle_s - pend.idle_at
        return max(0.0, stall - idle)

    def _deadline_miss(self, s: _Slot, pend: _Pending) -> None:
        """Latency-aware early exit: the reply is overdue (or arrived past
        its deadline), so the row's edge l_ee2 token wins."""
        s.stats.deadline_misses += 1
        s.miss_streak += 1
        s.stats.stall_s += self.vnow - pend.stall_from
        s.stats.overlap_s += self._hidden_s(pend)
        s.stats.exits_l2 += 1
        self._emit(s, pend.provisional)
        if (self.fallback_after
                and s.miss_streak >= self.fallback_after
                and not s.standalone):
            s.standalone = True
            s.stats.fallbacks += 1

    def _resolve(self) -> None:
        """Drain the replies that have arrived by the current virtual time,
        then expire deadlines."""
        for rep in self.channel.poll(self.vnow):
            s = self.slots[rep.slot] if rep.slot < self.B else None
            if (s is None or not s.active or s.seq != rep.seq
                    or rep.handle not in s.pending):
                # the slot retired or was refilled: a late reply must never
                # land on its successor
                self.late_drops += 1
                continue
            pend = s.pending.pop(rep.handle)
            if rep.arrival_t > pend.deadline_t:
                # arrival and deadline crossed within one clock advance:
                # the deadline fired first, so the reply is late even
                # though both show only now
                self._deadline_miss(s, pend)
                self.late_drops += 1
                self._maybe_finish(s)
                continue
            tok = self._reply_token(rep)
            s.stats.cloud_requests += 1
            s.stats.stall_s += self.vnow - pend.stall_from
            s.stats.overlap_s += self._hidden_s(pend)
            s.miss_streak = 0
            self._emit(s, tok)
            self._maybe_finish(s)
        # latency-aware early exit: overdue replies commit the edge token
        for s in self.slots:
            if not s.active or not s.pending:
                continue
            for h, pend in list(s.pending.items()):
                if pend.deadline_t > self.vnow:
                    continue
                del s.pending[h]
                self._deadline_miss(s, pend)
                self._maybe_finish(s)

    def _advance_idle(self) -> None:
        """Every active row waits on the channel: jump the virtual clock to
        the next reply arrival or deadline (never busy-wait)."""
        cands = []
        nxt = self.channel.next_arrival()
        if nxt is not None:
            cands.append(nxt)
        for s in self.slots:
            if s.active:
                cands.extend(p.deadline_t for p in s.pending.values())
        cands = [t for t in cands if t != math.inf]
        if not cands:
            raise RuntimeError(
                "scheduler wedged: every row is blocked on the channel but "
                "it has nothing in flight and no finite deadline")
        target = max(self.vnow, min(cands))
        self._idle_s += target - self.vnow     # nothing decodes while idle
        self.vnow = target

    def _emit(self, slot: _Slot, tok: int) -> None:
        slot.tokens.append(tok)
        slot.emit_ts.append(self.vnow)
        slot.last_token = tok
        if self.mode == "cloud":
            slot.stats.tokens += 1

    # -- driver -------------------------------------------------------------
    def _collect(self, results, stats) -> None:
        """Retire finished slots (frees them for the next admission)."""
        for s in self.slots:
            if s.req is not None and not s.active:
                results[s.req.index] = s.tokens
                stats[s.req.index] = s.stats
                s.req = None

    def run(self, requests: Sequence[Request]):
        """Drain a request list through the slot pool; returns
        (token lists, per-request GenStats) in submission order."""
        for i, r in enumerate(requests):
            r.index = i
            r.arrival_t += self.vnow
        queue = collections.deque(requests)
        results: List[Optional[List[int]]] = [None] * len(requests)
        stats: List[Optional[GenStats]] = [None] * len(requests)
        v0 = self.vnow
        self.late_drops = 0
        # a reused channel must not leak the previous run's link/service
        # virtual times (or stale in-flight replies) into this run's trace
        self.channel.reset()
        while queue or any(s.active for s in self.slots):
            admitted = self._admit(queue)
            self._collect(results, stats)     # finished at admission
            if any(s.active for s in self.slots):
                self.tick()
                self._collect(results, stats)
            elif queue and not admitted:
                # nothing active, nothing admitted, yet work remains: no
                # tick can ever free pages (conservative admission makes
                # this impossible; an admission that finished instantly
                # sets ``admitted`` and refills)
                raise RuntimeError(
                    f"scheduler wedged: {len(queue)} queued, 0 active, "
                    f"pool {self.pool and self.pool.free_pages} pages free")
        # replies still in flight belong to retired slots — discard them
        self.late_drops += self.channel.drop_in_flight()
        self.last_virtual_time = self.vnow - v0
        return results, stats


def run_multi(scheds: Sequence[BatchScheduler],
              request_lists: Sequence[Sequence[Request]]):
    """Drive several ``BatchScheduler``s (edge engines) in lockstep rounds
    against one shared cloud (paper §5: N edge clients, one server).

    Each engine keeps its own virtual clock, channel and edge caches; the
    cloud side is shared: a ``CloudServicePoint`` (timing) common to the
    engines' channels and, in cloud-batch mode, a ``CloudBatcher``
    (compute) that coalesces the round's concurrent requests into one
    masked cloud step.  Shared service points are reset once per run.
    Returns (per-engine token lists, per-engine stats, virtual makespan
    across engines); an engine handed no request stays idle at 0."""
    queues = []
    for reqs, s in zip(request_lists, scheds):
        for i, r in enumerate(reqs):
            r.index = i
            r.arrival_t += s.vnow
        queues.append(collections.deque(reqs))
    results = [[None] * len(rs) for rs in request_lists]
    stats = [[None] * len(rs) for rs in request_lists]
    v0 = [s.vnow for s in scheds]
    services = {}
    for s in scheds:
        s.late_drops = 0
        s.channel.reset()
        svc = getattr(s.channel, "service", None)
        if svc is not None:
            services[id(svc)] = svc
    for svc in services.values():
        svc.reset()      # a shared point resets once per run, not per channel

    def busy(i: int) -> bool:
        return bool(queues[i]) or any(sl.active for sl in scheds[i].slots)

    while any(busy(i) for i in range(len(scheds))):
        progressed = False
        for i, s in enumerate(scheds):
            if not busy(i):
                continue
            progressed |= s._admit(queues[i])
            s._collect(results[i], stats[i])
            if any(sl.active for sl in s.slots):
                s.tick()
                s._collect(results[i], stats[i])
                progressed = True
        if not progressed:
            raise RuntimeError(
                "multi-engine scheduler wedged: requests queued but no "
                "engine can admit or tick (shared cloud slots or pages "
                "exhausted with nothing running?)")
    for s, v in zip(scheds, v0):
        s.late_drops += s.channel.drop_in_flight()
        s.last_virtual_time = s.vnow - v
    makespan = max(s.last_virtual_time for s in scheds)
    return results, stats, makespan


def _refuse(what: str, options: Dict[str, tuple]) -> None:
    """Raise ``NotImplementedError`` for every option that is on, naming
    the ROADMAP queue item that ports it; ``options``: name -> (on,
    item)."""
    bad = {name: item for name, (on, item) in options.items() if on}
    if bad:
        raise NotImplementedError(
            f"{what} {sorted(bad)} are not ported yet ("
            + ", ".join(f"{n}: ROADMAP {i}" for n, i in sorted(bad.items()))
            + ")")


class ServingSystem:
    """End-to-end multi-client co-inference on the model's device."""

    def __init__(self, model: Model, ccfg: CollmConfig = CollmConfig()):
        self.model = model
        self.ccfg = ccfg
        self.collm = CoLLM(model, ccfg)
        self.cloud = CloudServer(self.collm)
        self._schedulers: Dict[tuple, BatchScheduler] = {}

    @torch.no_grad()
    def generate(self, prompts: Sequence[np.ndarray], max_new: int,
                 mode: str = "collm", max_seq: Optional[int] = None, *,
                 num_slots: Optional[int] = None, sampler: str = "greedy",
                 temperature: float = 1.0, top_k: int = 0,
                 eos_id: Optional[int] = None, seed: int = 0,
                 max_ctx: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 channel: Optional[CloudChannel] = None,
                 tick_time_s: float = 0.0, overlap: bool = True,
                 fallback_after: int = 0, watermark: int = 0,
                 preempt_schedule: Optional[Sequence] = None,
                 arrivals: Optional[Sequence[float]] = None,
                 slo_ttft_s: Optional[float] = None,
                 slo_tpot_s: Optional[float] = None,
                 adaptive: Any = None, resume_cost: Any = None
                 ) -> Dict[str, Any]:
        """mode: collm | standalone | cloud.  One client per prompt, decoded
        by the continuous-batching ``BatchScheduler`` (num_slots streams in
        flight; defaults to min(len(prompts), 8)).  The KV layout follows
        ``CollmConfig.kv_layout``; ``max_ctx``/``num_pages`` size the paged
        pool (defaults: max_ctx = max_seq, num_pages = dense-equivalent).

        ``channel`` selects the cloud transport (default: the blocking
        ``SyncChannel``); ``tick_time_s`` is the virtual edge compute per
        decode tick, ``overlap=False`` degrades the dispatch to a blocking
        drain, and ``fallback_after`` consecutive deadline misses flip a
        stream to standalone.  ``sampler="temperature"`` draws with
        ``temperature`` and ``top_k`` from a generator seeded with
        ``seed``.  Refused with their ROADMAP item: ``watermark`` and
        ``preempt_schedule`` (A.4), open-loop ``arrivals``, SLO targets,
        ``adaptive`` and ``resume_cost`` (A.6).  Returns the JAX package's
        result keys."""
        _refuse("generate options", {
            "arrivals": (arrivals is not None, "A.6"),
            "slo": (slo_ttft_s is not None or slo_tpot_s is not None,
                    "A.6")})
        slots = num_slots or max(1, min(len(prompts), 8))
        longest = max(len(p) for p in prompts)
        max_seq = max_seq or (longest + max_new + 8)
        max_seq = max(max_seq, _bucket(longest))
        key = (mode, slots, max_seq, sampler, temperature, top_k, seed,
               max_ctx, num_pages,
               id(channel) if channel is not None else None,
               tick_time_s, overlap, fallback_after)
        sched = self._schedulers.get(key)
        if sched is None:
            # bounded cache: each scheduler owns pooled device caches
            # (slots x max_seq x layers), so evict oldest beyond a few
            while len(self._schedulers) >= 4:
                self._schedulers.pop(next(iter(self._schedulers)))
            sched = BatchScheduler(
                self.collm, self.cloud.cm, slots, max_seq, mode=mode,
                sampler=sampler, temperature=temperature, top_k=top_k,
                seed=seed, max_ctx=max_ctx, num_pages=num_pages,
                channel=channel, tick_time_s=tick_time_s, overlap=overlap,
                fallback_after=fallback_after, watermark=watermark,
                preempt_schedule=preempt_schedule, adaptive=adaptive,
                resume_cost=resume_cost)
            self._schedulers[key] = sched
        reqs = [Request(device_id=f"edge-{i}", prompt=np.asarray(p),
                        max_new=max_new, eos_id=eos_id)
                for i, p in enumerate(prompts)]
        results, stats = sched.run(reqs)
        return {"tokens": results, "stats": _aggregate(stats),
                "per_client": stats, "cm_stats": self.cloud.cm.stats(),
                "num_slots": slots,
                "virtual_time": sched.last_virtual_time,
                "late_drops": sched.late_drops,
                "channel_stats": sched.channel.stats.as_row(),
                "preemptions": 0, "oops": 0,
                "adaptive": None,
                "pool_stats": (dataclasses.asdict(sched.pool.stats)
                               if sched.pool is not None else None)}

    @torch.no_grad()
    def generate_multi(self, prompts: Sequence[np.ndarray], max_new: int,
                       *, n_engines: Optional[int] = None,
                       mode: str = "collm", max_seq: Optional[int] = None,
                       eos_id: Optional[int] = None,
                       cloud_batch: bool = True,
                       max_batch: Optional[int] = None,
                       channels: Optional[Sequence[CloudChannel]] = None,
                       preempt_schedules: Optional[Sequence] = None,
                       tick_time_s: float = 0.0, overlap: bool = True,
                       fallback_after: int = 0,
                       arrivals: Optional[Sequence[float]] = None,
                       slo_ttft_s: Optional[float] = None,
                       slo_tpot_s: Optional[float] = None) -> Dict[str, Any]:
        """Multi-client mode (paper §5): each edge client is its own
        single-slot ``BatchScheduler`` with its own channel and virtual
        clock; all of them share ONE cloud.  Prompt j goes to engine
        j % n_engines (default: one engine per prompt).

        With ``cloud_batch`` (default) a shared ``CloudBatcher`` serves
        every client out of a pooled batch-major cloud cache, coalescing
        concurrent below-θ requests from different engines into one masked
        cloud step; with ``cloud_batch=False`` each engine computes its own
        cloud calls (the per-request FIFO cloud the batcher is compared
        with).  ``channels`` optionally gives one ``CloudChannel`` per
        engine, e.g. ``AsyncSimChannel``s sharing one ``CloudServicePoint``;
        the default is a ``SyncChannel`` each.  Refused with their ROADMAP
        item: ``preempt_schedules`` (A.4), open-loop ``arrivals`` and SLO
        targets (A.6).  Returns the JAX package's result keys, with
        ``n_engines`` and, in cloud-batch mode, the batcher's stats row."""
        _refuse("generate_multi options", {
            "preempt_schedules": (bool(preempt_schedules), "A.4"),
            "arrivals": (arrivals is not None, "A.6"),
            "slo": (slo_ttft_s is not None or slo_tpot_s is not None,
                    "A.6")})
        n = n_engines or len(prompts)
        if channels is not None and len(channels) != n:
            raise ValueError(f"need one channel per engine "
                             f"({len(channels)} != {n})")
        longest = max(len(p) for p in prompts)
        max_seq = max_seq or (longest + max_new + 8)
        max_seq = max(max_seq, _bucket(longest))
        batcher = None
        if cloud_batch and mode == "collm":
            batcher = CloudBatcher(self.collm, self.cloud.cm, n, max_seq,
                                   max_batch=max_batch)
        scheds = [BatchScheduler(
            self.collm, self.cloud.cm, 1, max_seq, mode=mode,
            channel=(channels[i] if channels is not None else None),
            tick_time_s=tick_time_s, overlap=overlap,
            fallback_after=fallback_after, cloud_batcher=batcher)
            for i in range(n)]
        per_engine = [[] for _ in range(n)]
        assign = [[] for _ in range(n)]
        for j, p in enumerate(prompts):
            per_engine[j % n].append(Request(
                device_id=f"edge-{j}", prompt=np.asarray(p),
                max_new=max_new, eos_id=eos_id))
            assign[j % n].append(j)
        results, stats, makespan = run_multi(scheds, per_engine)
        tokens: List[Optional[List[int]]] = [None] * len(prompts)
        flat: List[Optional[GenStats]] = [None] * len(prompts)
        for e in range(n):
            for k, j in enumerate(assign[e]):
                tokens[j] = results[e][k]
                flat[j] = stats[e][k]
        ch_agg = ChannelStats()
        for s in scheds:
            for f in dataclasses.fields(ChannelStats):
                setattr(ch_agg, f.name, getattr(ch_agg, f.name)
                        + getattr(s.channel.stats, f.name))
        out = {"tokens": tokens, "stats": _aggregate(flat),
               "per_client": flat, "cm_stats": self.cloud.cm.stats(),
               "n_engines": n, "virtual_time": makespan,
               "late_drops": sum(s.late_drops for s in scheds),
               "channel_stats": ch_agg.as_row()}
        if batcher is not None:
            # the wave compute runs in the batcher, not in any one engine's
            # dispatch: fold it into the aggregate (it cannot be attributed
            # per client)
            out["stats"].cloud_time += batcher.stats.cloud_time
            out["batcher"] = batcher.stats.as_row()
        return out

    @torch.no_grad()
    def generate_sequential(self, prompts: Sequence[np.ndarray],
                            max_new: int, mode: str = "collm",
                            max_seq: Optional[int] = None,
                            channel: Optional[CloudChannel] = None
                            ) -> Dict[str, Any]:
        """mode: collm | standalone | cloud.  The per-client loops (batch=1,
        one Python iteration per token).  ``channel`` optionally shares one
        cloud channel across the clients; default: a fresh blocking
        ``SyncChannel`` per client."""
        if mode not in ("collm", "standalone", "cloud"):
            raise ValueError(f"unknown mode {mode!r}")
        max_seq = max_seq or (max(len(p) for p in prompts) + max_new + 8)
        results, stats = [], []
        for i, prompt in enumerate(prompts):
            toks, st = self._generate_one(f"edge-{i}", np.asarray(prompt),
                                          max_new, mode, max_seq,
                                          channel=channel)
            results.append(toks)
            stats.append(st)
        return {"tokens": results, "stats": _aggregate(stats),
                "per_client": stats, "cm_stats": self.cloud.cm.stats()}

    def _generate_one(self, device_id: str, prompt: np.ndarray, max_new: int,
                      mode: str, max_seq: int,
                      channel: Optional[CloudChannel] = None):
        model, collm = self.model, self.collm
        dev = model.device
        st = GenStats()
        if channel is None:
            channel = SyncChannel()  # the one cloud-request path (blocking)
        batch = {"tokens": torch.as_tensor(prompt[None, :], dtype=torch.long,
                                           device=dev)}

        if mode == "cloud":
            caches = model.init_cache(1, max_seq)
            t0 = time.perf_counter()
            x, _, caches, _ = model.prefill(batch, caches)
            tok = model.logits(x[:, -1:])[:, 0].argmax(dim=-1)
            toks = [int(tok[0])]
            pos = len(prompt)
            for _ in range(max_new - 1):
                tok, _, caches = collm.full_step(tok[:, None].long(), caches,
                                                 pos)
                toks.append(int(tok[0]))
                pos += 1
            st.cloud_time += time.perf_counter() - t0
            st.tokens = len(toks)
            return toks, st

        client = EdgeClient(collm, device_id, 1, max_seq)
        t0 = time.perf_counter()
        decisions, h1_seq = client.prefill(batch)
        st.edge_time += time.perf_counter() - t0

        prefill_logits = None
        if mode == "collm":
            t0 = time.perf_counter()
            # the prompt's l_ee1 hidden goes to the cloud as computed, but
            # is billed in the configured wire format
            prefill_logits = self.cloud.register(device_id, 1, max_seq,
                                                 h1_prompt=h1_seq)
            st.cloud_time += time.perf_counter() - t0
            st.upload_bytes += hidden_wire_bytes(
                model.cfg.d_model, self.ccfg.wire_format,
                seq=h1_seq.shape[1])

        # first token from the prompt's last position
        tok_arr, exited, _ = first_confident_exit(decisions, collm.ccfg.theta)
        if mode == "standalone":
            tok = int(decisions[collm.l_ee2].token[0])
        elif bool(exited[0]) or mode != "collm":
            tok = int(tok_arr[0])
        else:
            # cloud already prefilled through the prompt: its last-position
            # logits ARE the cloud answer for the first token
            st.cloud_requests += 1
            tok = int(prefill_logits[0, 0].argmax())
        toks = [tok]
        st.tokens += 1

        for _ in range(max_new - 1):
            t0 = time.perf_counter()
            out = client.step(torch.tensor([[tok]], dtype=torch.long,
                                           device=dev))
            confs = {l: float(d.confidence[0])
                     for l, d in out.decisions.items()}
            st.edge_time += time.perf_counter() - t0
            st.tokens += 1
            st.confidences.append((confs.get(collm.l_ee1, 0.0),
                                   confs.get(collm.l_ee2, 0.0)))

            if mode == "standalone":
                tok = int(out.decisions[collm.l_ee2].token[0])
                if confs.get(collm.l_ee1, 0.0) >= collm.ccfg.theta:
                    st.exits_l1 += 1
                else:
                    st.exits_l2 += 1
                toks.append(tok)
                continue

            # parallel upload (always dispatched at l_ee1): billed on the
            # channel once, here; a later request that consumes it (or a
            # backfill ring of them) is a token-sized control message
            pkt = StatePacket(hidden=out.upload, pos=client.pos - 1)
            self.cloud.receive_upload(device_id, client.pos - 1, pkt)
            st.upload_bytes += pkt.nbytes()
            channel.notify_upload(0, pkt.nbytes(), 0.0)

            if bool(out.exited[0]):
                if confs.get(collm.l_ee1, 0.0) >= collm.ccfg.theta:
                    st.exits_l1 += 1
                else:
                    st.exits_l2 += 1
                tok = int(out.token[0])
            else:
                t0 = time.perf_counter()
                self.cloud.request(channel, device_id, client.pos - 1,
                                   backfill=self.ccfg.backfill)
                (rep,) = channel.poll()
                tok = int(rep.reply[0].argmax())
                st.cloud_time += time.perf_counter() - t0
                st.cloud_requests += 1
            toks.append(tok)

        if mode == "collm":
            self.cloud.finish(device_id)
        return toks, st


def token_agreement(a: Sequence[int], b: Sequence[int]) -> float:
    """Longest-common-subsequence F1 — the ROUGE-L proxy used in
    EXPERIMENTS.md to compare strategies' generations."""
    a, b = list(a), list(b)
    if not a or not b:
        return 0.0
    m, n = len(a), len(b)
    dp = np.zeros((m + 1, n + 1), np.int32)
    for i in range(m):
        for j in range(n):
            dp[i + 1, j + 1] = (dp[i, j] + 1 if a[i] == b[j]
                                else max(dp[i, j + 1], dp[i + 1, j]))
    lcs = dp[m, n]
    prec, rec = lcs / m, lcs / n
    return 0.0 if lcs == 0 else 2 * prec * rec / (prec + rec)
