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
temperature with top-k.  With ``CollmConfig.speculative`` a below-θ row
commits its provisional edge token and keeps decoding; up to ``spec_k``
such tokens ship as one verification request, and the reply keeps the
agreeing prefix and rewinds the stream at the first disagreement.  With
``CollmConfig.preemption`` the paged pool admits optimistically (the
prompt's pages plus a ``watermark``) and a decode tick that finds no free
page preempts a victim stream, which resumes later by re-prefill
("recompute") or from host memory ("swap").  With
``CollmConfig.chunked_prefill`` a prompt is prefilled one page-sized chunk
a tick, interleaved with the other slots' decode; ``prefix_share`` adds a
radix prefix cache over the paged pool, so prompts behind a common prefix
map its pages (and upload it once), with copy-on-write at the first
divergent write.  Open-loop replay stamps each request with a virtual
arrival time and SLO targets, and ``adaptive`` closes control loops over
the admission gate, the pool's watermark and the resume mode, priced by a
``ResumeCostModel``.
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
from repro_torch.core.paging import (PREEMPT_POLICIES, OutOfPages,
                                     PagePool, SwapPool, VictimCandidate,
                                     pages_needed, select_victim)
from repro_torch.core.transport import (TOKEN_BYTES, ChannelStats,
                                        CloudChannel, StatePacket,
                                        SyncChannel, draft_request_bytes,
                                        hidden_wire_bytes)
from repro_torch.models.cache_tree import cache_bytes
from repro_torch.models.transformer import Caches, Model
from repro_torch.serving import sampler as samplerlib
from repro_torch.serving.adaptive import (AdaptiveConfig,
                                          AdaptiveController,
                                          ResumeCostModel)
from repro_torch.serving.cloud_batcher import (CloudBatcher, _bucket,
                                               _copy_pages_tree,
                                               _reset_pages_tree,
                                               _scatter_row,
                                               _scatter_row_paged,
                                               _write_pages_tree, all_paged,
                                               build_upload_ring,
                                               gather_slot_pages,
                                               rebind_slot_pages,
                                               snapshot_to_device)


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
    """One client stream queued for the scheduler.

    ``arrival_t`` is the stream's open-loop virtual arrival time: the
    scheduler never admits it earlier (closed-loop replay leaves it 0).
    ``slo_ttft_s`` / ``slo_tpot_s`` arm per-stream service objectives:
    time-to-first-token and mean time-per-output-token budgets checked at
    retirement (``GenStats.slo_attainment``)."""
    device_id: str
    prompt: np.ndarray
    max_new: int
    eos_id: Optional[int] = None
    index: int = 0                   # submission order (result slot)
    arrival_t: float = 0.0
    slo_ttft_s: Optional[float] = None
    slo_tpot_s: Optional[float] = None


@dataclasses.dataclass
class _DraftTok:
    """One provisional token of a slot's edge draft (speculative path).

    The upload packet is popped from the ContentManager at draft time (the
    upload window must never release a position still awaiting
    verification) and held here until the draft flushes into one
    verification request.  ``ring_idx`` is the entry's index in that
    request's upload ring (set at flush; the reply's per-position logits
    are indexed with it)."""
    pos: int
    tok_index: int           # index in slot.tokens of the provisional token
    provisional: int
    pkt: Any                 # the popped StatePacket
    ring_idx: int = 0


@dataclasses.dataclass
class _Pending:
    """One in-flight cloud request of a slot.

    Speculative requests ship k-token drafts: ``draft`` lists the request's
    provisional tokens in position order, ``tok_index``/``provisional``
    mirror the FIRST entry (preemption cuts at the earliest unvalidated
    token) and ``pos`` the LAST entry (a rewind drops the requests past its
    cut).  Other requests leave ``draft`` as None."""
    pos: int                 # decode position the request serves
    tok_index: int           # index in slot.tokens its token lands at
    provisional: int         # edge l_ee2 token committed on deadline miss
    stall_from: float        # virtual submit time
    deadline_t: float
    idle_at: float = 0.0     # engine idle integral at submit (overlap_s)
    draft: Optional[List[_DraftTok]] = None


@dataclasses.dataclass
class _Slot:
    """One row of the batched pool.  Lifecycle:
    FREE -> (admit: prefill + scatter row caches) ACTIVE
         -> (decode ticks) ... -> (EOS / max_new) FINISHED -> FREE.

    ``seq`` is the slot *generation*: it increments at every admission (and
    preemption and resume), so a cloud reply issued for an earlier stream
    can never be applied to the slot's successor.  ``pending`` holds the
    in-flight cloud requests (at most one without speculation: the row
    stalls; any number with ``CollmConfig.speculative``: the row keeps
    decoding on provisional tokens).  ``events`` records each emitted
    token's origin ("admit"/"l1"/"l2"/"cloud"/"spec"/"full") so that a
    rewind can unwind the per-token counters exactly.  ``miss_streak``
    counts deadline misses in a row; ``standalone`` is the latency
    fallback (the row stops uploading and serves itself)."""
    index: int
    req: Optional[Request] = None
    stats: Optional[GenStats] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    # virtual commit time of each entry of ``tokens`` (kept in lockstep
    # through rewinds and preemption)
    emit_ts: List[float] = dataclasses.field(default_factory=list)
    pos: int = 0
    last_token: int = 0
    active: bool = False
    seq: int = 0
    pending: Dict[int, _Pending] = dataclasses.field(default_factory=dict)
    events: List[str] = dataclasses.field(default_factory=list)
    miss_streak: int = 0
    standalone: bool = False
    admit_seq: int = 0           # global admission order (victim policies)
    # buffered (not yet dispatched) draft tokens of the speculative path:
    # up to spec_k below-θ provisional tokens, flushed as ONE request
    draft: List[_DraftTok] = dataclasses.field(default_factory=list)
    # uploads the cloud consumed for this stream, in consumption order: a
    # recompute resume replays them to rebuild the cloud KV (gaps
    # included) without recomputing the hidden states
    cloud_pkts: List[tuple] = dataclasses.field(default_factory=list)
    # chunked-prefill state machine (CollmConfig.chunked_prefill): while
    # ``prefill_prompt`` is set the slot is mid-prefill, and each tick
    # computes ONE page-sized chunk starting at ``prefill_pos``.
    # ``prefill_wait`` / ``prefill_wait_cloud`` list shared page ids (the
    # engine's pool / the batcher's) still being computed by their owning
    # stream: the sharer stalls until they are filled, then computes only
    # its suffix.
    prefill_prompt: Optional[np.ndarray] = None
    prefill_pos: int = 0
    prefill_wait: List[int] = dataclasses.field(default_factory=list)
    prefill_wait_cloud: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Checkpoint:
    """A preempted stream, frozen between its slot generations.

    Everything needed to resume is on the host: the emitted tokens (the
    resume point is ``len(prompt) + len(tokens) - 1`` — the last emitted
    token is fed again, so an interrupted edge pass simply runs again),
    the stream's stats and events, the ContentManager uploads still
    pending, and the consumed upload packets whose replay rebuilds the
    cloud KV.  ``swap_key`` points into the scheduler's ``SwapPool`` when
    the device pages were swapped out instead of dropped."""
    req: Request
    stats: GenStats
    tokens: List[int]
    emit_ts: List[float]
    events: List[str]
    cloud_pkts: List[tuple]               # [(pos, StatePacket)] pos < resume
    uploads: List[tuple]                  # pending CM uploads, pos < resume
    standalone: bool
    miss_streak: int
    swap_key: Optional[int] = None        # SwapPool key (swap mode)
    swap_pages: int = 0                   # pages the snapshot restores
    batcher_swap: Optional[dict] = None   # CloudBatcher.swap_out snapshot


class BatchScheduler:
    """Continuous-batching multi-slot decode engine.

    B client streams advance together under one batched edge step with
    per-row positions; exits are gated per row; one masked cloud call
    serves all below-θ rows of a tick; finished slots are refilled from
    the queue.  KV lives in per-slot dense rings (``kv_layout="dense"``)
    or in a block-paged pool shared across slots (``"paged"``, float or
    int8 pages): admission allocates the prompt's pages, each decode tick
    allocates a page only when a row crosses a page boundary, and
    retirement frees the slot's pages and invalidates them on the card.
    Admission follows ``CollmConfig.preemption``: ``"off"`` waits while
    the pool cannot cover a request's worst case (conservative
    back-pressure, a decode alloc never fails); ``"recompute"``/``"swap"``
    admit on the prompt's pages alone (holding ``watermark`` pages back)
    and answer a decode-time ``OutOfPages`` by preempting a victim stream
    chosen by ``preempt_policy``: checkpoint, free its pages, resume it
    later by re-prefill or from a host swap.  Preemption is invisible in
    greedy output space.  ``preempt_schedule`` ([(tick, slot), ...])
    forces preemptions at given ticks.  With ``CollmConfig.chunked_prefill``
    the prompt is prefilled ONE page-sized chunk per tick through the paged
    decode write path, interleaved with the other slots' decode (a
    per-slot state machine); with ``prefix_share`` on top, admission first
    consults the pool's radix prefix index: prompt pages another live
    stream (or the cache) already holds are mapped by reference
    (suffix-only prefill, uploads deduplicated), a whole-prompt *terminal*
    hit skips prefill entirely, and the first divergent write into a
    shared page splits it copy-on-write.  The block table lives on the host
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
    (zero latency) is the blocking engine, token for token.  With
    ``CollmConfig.speculative`` a below-θ row does not stall: it commits
    the provisional edge token, keeps decoding, and reconciles on arrival
    (keep on match, rewind-and-replace on mismatch).  Samplers other than
    greedy draw from a ``torch.Generator`` seeded with ``seed`` on the
    model's device.  Requests carry open-loop arrival times (admission
    waits for them) and SLO targets; ``adaptive`` (an ``AdaptiveConfig``)
    tunes the pool's watermark, gates admission on the fluid capacity
    curve and picks each victim's resume mode, and ``resume_cost`` (a
    ``ResumeCostModel``) bills each resume into the virtual clock."""

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
                 adaptive: Optional[AdaptiveConfig] = None,
                 resume_cost: Optional[ResumeCostModel] = None):
        if mode not in ("collm", "standalone", "cloud"):
            raise ValueError(mode)
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
        self._spec = bool(self.ccfg.speculative) and mode == "collm"
        # draft length of the speculative path: below-θ rows accumulate up
        # to spec_k provisional tokens into one verification request
        self._spec_k = int(self.ccfg.spec_k) if self._spec else 1
        if self._spec and sampler != "greedy":
            raise ValueError("speculative decode reconciles token ids and "
                             "requires greedy sampling")
        if self._spec and not self.model.attention_only():
            raise ValueError("speculative decode rewinds positions; "
                             "recurrent state cannot rewind")
        # chunked prefill + radix prefix sharing: admission maps
        # shared-prefix pages and prefills the suffix one page-sized chunk
        # per tick
        self._chunked = bool(self.ccfg.chunked_prefill)
        self._prefix_share = bool(self.ccfg.prefix_share)
        if self._chunked:
            if mode == "cloud":
                raise ValueError(
                    "chunked_prefill is implemented for the edge-resident "
                    'modes ("collm"/"standalone"), not mode="cloud"')
            if not self.model.attention_only():
                raise ValueError(
                    "chunked_prefill writes chunks through the paged decode "
                    "path and requires an attention-only model (recurrent "
                    "state cannot resume mid-prompt)")
        if self._prefix_share and sampler != "greedy":
            raise ValueError(
                "prefix_share memoizes greedy first tokens (terminal hits) "
                "and requires greedy sampling")
        # a stalled row takes a placeholder step through the batched graph:
        # harmless to attention (the slot is written again before it is
        # read), but recurrent state would advance, so collm mode masks
        # the edge step of recurrent models.  Chunked mode masks too: a
        # mid-prefill row's placeholder write would otherwise land in its
        # (possibly shared) page-0 prefix
        self._mask_edge = ((mode == "collm"
                            and not self.model.attention_only())
                           or self._chunked)
        # recurrent layers cannot take a right-padded prefill (their state
        # would advance through the pads): they prefill the exact prompt
        self._pad_ok = self.model.attention_only()

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
                                 pages_needed(self.max_ctx, ps),
                                 watermark=watermark,
                                 prefix_cache=self._prefix_share)
            row_seq = _bucket(self.max_ctx)
        else:
            self.max_ctx = max_seq
            row_seq = max_seq
        self._row_seq = row_seq        # single-row prefill cache capacity

        # preemption: admission is optimistic, and a decode-time
        # OutOfPages checkpoints a victim stream that resumes later by
        # re-prefill ("recompute") or a host page round trip ("swap");
        # "off" keeps the conservative worst-case admission
        self.preemption = self.ccfg.preemption
        if self.preemption not in ("off", "recompute", "swap"):
            raise ValueError(f"preemption {self.preemption!r}")
        self.preempt_policy = self.ccfg.preempt_policy
        if self.preempt_policy not in PREEMPT_POLICIES:
            raise ValueError(f"preempt_policy {self.preempt_policy!r} "
                             f"(choose from {PREEMPT_POLICIES})")
        if self.preemption != "off" and sampler != "greedy":
            raise ValueError(
                "preemption requires greedy sampling: per-stream sampler "
                "state cannot be checkpointed out of the shared generator")
        if self.preemption == "swap" and self.layout != "paged":
            raise ValueError('preemption="swap" swaps KV pages and needs '
                             'kv_layout="paged" (use "recompute" on dense)')
        self._preempted = collections.deque()     # of _Checkpoint
        self.swap = SwapPool() if self.preemption == "swap" else None
        self._swap_key = 0
        self._admit_counter = 0
        self._tick_no = 0
        self.preemptions = 0          # scheduler-lifetime preempt events
        self.oops = 0                 # scheduler-lifetime OutOfPages events
        self._arrival_hint: Optional[float] = None   # next queued arrival
        # resume pricing and adaptive control: the cost model is physics
        # shared by every configuration; the controller is the optional
        # loop that tunes watermark, admission and resume mode against it
        self._resume_cost = resume_cost
        self._adaptive: Optional[AdaptiveController] = None
        self._kv_tok_bytes: Optional[float] = None
        if adaptive is not None:
            if self.pool is None:
                raise ValueError("adaptive control tunes the paged pool's "
                                 "watermark and admission; needs "
                                 'kv_layout="paged"')
            self._adaptive = AdaptiveController(adaptive)
            self._adaptive.attach(self.pool, resume_cost)
        self._preempt_schedule: Dict[int, List[int]] = {}
        if preempt_schedule:
            if self.preemption == "off":
                raise ValueError("preempt_schedule needs preemption enabled")
            for t, idx in preempt_schedule:
                self._preempt_schedule.setdefault(int(t), []).append(int(idx))

        # pooled caches, and one single-row prefill cache per partition
        # that every admission reuses (a prefill rewrites slots [0, pad)
        # and invalidates everything from the true length on)
        if mode == "cloud":
            self.main_caches = self._init_pool_cache(
                collm.init_main_cache, collm.init_main_cache_paged)
            self._full_row0 = self.model.init_cache(1, row_seq)
        else:
            self.edge_caches = self._init_pool_cache(
                collm.init_edge_cache, collm.init_edge_cache_paged)
            self._edge_row0 = collm.init_edge_cache(1, row_seq)
            if mode == "collm" and self._batcher is None:
                self.cloud_caches = self._init_pool_cache(
                    collm.init_cloud_cache, collm.init_cloud_cache_paged)
                self._cloud_row0 = collm.init_cloud_cache(1, row_seq)

        if self.preemption == "swap":
            # a page-only snapshot would silently lose a dense cache leaf
            trees = self._trees()
            if self._batcher is not None:
                trees.append(self._batcher.caches)
            if not all(all_paged(t) for t in trees):
                raise ValueError(
                    'preemption="swap" requires every cache node to be '
                    'paged (attention-only models); use "recompute"')

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
        """Device bytes held by the pooled KV and recurrent-state caches
        (the number the paged layout shrinks: num_pages x page_size instead
        of B x max_seq), every cache leaf counted as the JAX package
        counts it."""
        return sum(cache_bytes(tree) for tree in self._trees())

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
        """Worst-case pages still owed to the active streams: the
        never-preempt (``preemption="off"``) admission check, so that an
        admitted stream can always finish."""
        out = 0
        for s in self.slots:
            if not s.active or s.req is None:
                continue
            worst = pages_needed(len(s.req.prompt) + s.req.max_new,
                                 self.pool.page_size)
            out += max(0, worst - self.pool.owned_pages(s.index))
            if self.pool.prefix_cache:
                # a stream's first decode write may hit a still-shared tail
                # page: the copy-on-write split takes one more free page
                # (a split leaves the owned count unchanged)
                lp_tail = len(s.req.prompt) // self.pool.page_size
                pg = self.pool.block_table[s.index, lp_tail]
                if pg >= 0 and self.pool.is_shared(int(pg)):
                    out += 1
        return out

    def _fits_now(self, need_pages: int) -> bool:
        """Optimistic admission: do ``need_pages`` fit the free list right
        now?  The watermark holds back decode headroom — except when
        nothing is running, where it would wedge the pool instead of
        protecting it."""
        free = self.pool.available_pages
        if not any(s.active for s in self.slots):
            # reclaimable = prefix-cache pages nobody maps: evictable on
            # demand, so an idle pool full of cached prefixes never wedges
            free = self.pool.free_pages + self.pool.reclaimable_pages
        return need_pages <= free

    def _admissible(self, req: Request, p_len: int, pad: int,
                    hit_pages: int = 0, batcher_hit: int = 0) -> bool:
        """Capacity check.  Impossible requests raise; a request the paged
        pool could serve but not *right now* stays queued (back-pressure).
        With preemption the check is optimistic — only the prompt's pages
        must fit (decode pages come from alloc-on-write, backstopped by
        preemption); with ``preemption="off"`` it is the conservative
        worst case, so a decode alloc can never fail.  ``hit_pages``
        prompt pages come from the radix prefix cache (shared mappings,
        not fresh allocations) and are discounted; pages only the prefix
        cache holds count as reclaimable."""
        if p_len + req.max_new > self.max_ctx or pad > self._row_seq:
            raise ValueError(
                f"request {req.device_id}: prompt {p_len} + max_new "
                f"{req.max_new} exceeds max context {self.max_ctx}")
        if self._batcher is not None \
                and not self._batcher.can_admit(p_len + req.max_new,
                                                hit_pages=batcher_hit):
            return False        # shared cloud pool full: wait for a release
        if self.pool is None:
            return True
        need_worst = pages_needed(p_len + req.max_new, self.pool.page_size)
        if self._prefix_share and p_len % self.pool.page_size:
            need_worst += 1     # CoW split of the shared or cached tail page
        if need_worst > self.pool.num_pages:
            raise ValueError(
                f"request {req.device_id}: needs {need_worst} pages but the "
                f"pool only has {self.pool.num_pages}")
        if self.preemption == "off":
            return need_worst - hit_pages <= (
                self.pool.free_pages + self.pool.reclaimable_pages
                - self._outstanding_pages())
        need_now = max(0, pages_needed(p_len, self.pool.page_size)
                       - hit_pages)
        if not self._fits_now(need_now):
            return False
        if self._adaptive is not None and any(s.active for s in self.slots):
            # fluid-ODE admission gate: hold the request while its
            # worst-case residency would overcommit the capacity curve.
            # Skipped when nothing runs: the gate protects running streams
            # from churn and never wedges an idle engine
            resident = (self.pool.num_pages - self.pool.free_pages
                        - self.pool.reclaimable_pages) * self.pool.page_size
            n_active = sum(1 for s in self.slots if s.active)
            if not self._adaptive.admit_ok(resident, n_active,
                                           p_len + req.max_new):
                return False
        return True

    def _next_admit_seq(self) -> int:
        self._admit_counter += 1
        return self._admit_counter

    def _reset_freed(self, freed: List[int]) -> None:
        """Invalidate freed physical pages (pos = -1) on every cache tree
        this engine holds, so reallocation can never leak their K/V."""
        if not freed:
            return
        for tree in self._trees():
            _reset_pages_tree(tree, freed)

    def _alloc_page(self, idx: int, lp: int) -> None:
        """``pool.alloc`` with prefix-cache reclaim: when the free list
        alone cannot serve, evict least recently used radix-cache pages
        nobody maps (and invalidate them on the device) before giving up.
        Raises ``OutOfPages`` only when free and reclaimable pages are
        both exhausted."""
        try:
            self.pool.alloc(idx, lp)
        except OutOfPages:
            freed = self.pool.evict_prefix(1)
            if not freed:
                raise
            self._reset_freed(freed)
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
        # preempted streams resume first (they hold finished work, and the
        # head of the line must not starve behind fresh admissions); while
        # any still waits for pages, new requests stay queued
        admitted = self._resume_preempted()
        if self._preempted:
            return admitted
        dev = self.model.device
        for slot in self.slots:
            if slot.active or slot.req is not None or not queue:
                # a finished-but-uncollected slot keeps its req until
                # _collect copies the results out — never reuse it here
                continue
            req: Request = queue[0]
            if req.arrival_t > self.vnow:
                # open-loop replay: the head request has not arrived yet,
                # and the queue is arrival-sorted so nothing behind it is
                # due either (the run loop jumps the clock when idle)
                break
            prompt = np.asarray(req.prompt, np.int32)
            p_len = len(prompt)
            # right-padded prefill is exact for attention (pads are
            # causally invisible to real tokens); recurrent layers take the
            # exact prompt
            pad = _bucket(p_len) if self._pad_ok else p_len
            # radix prefix hit: full prompt pages already resident in the
            # pool(s).  A *terminal* hit (whole prompt, memoized first
            # token) skips prefill compute entirely; otherwise the hit is
            # capped at (p_len-1)//ps full pages so the final chunk always
            # computes into a private page.  With a shared CloudBatcher
            # the usable hit is the smaller of both pools' hits: edge and
            # cloud pages must cover the same positions
            hit, hit_pages, b_hit, terminal = None, 0, 0, None
            if self._prefix_share:
                hit = self.pool.match_prefix([int(t) for t in prompt])
                cap = max(0, (p_len - 1) // self.pool.page_size)
                if self._batcher is not None:
                    b_hit = min(self._batcher.prefix_hit(prompt),
                                len(hit.pages), cap)
                    hit_pages = b_hit
                elif hit.terminal is not None:
                    terminal = hit.terminal
                    hit_pages = len(hit.pages) + (
                        1 if terminal[0] is not None else 0)
                else:
                    hit_pages = min(len(hit.pages), cap)
            if not self._admissible(req, p_len, pad, hit_pages=hit_pages,
                                    batcher_hit=b_hit):
                break                       # FIFO back-pressure: wait for pages
            queue.popleft()
            if self._chunked:
                self._admit_chunked(slot, req, prompt, hit, hit_pages,
                                    terminal)
                admitted = True
                if slot.prefill_prompt is None:   # terminal fast path
                    self._maybe_finish(slot)
                continue
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
                fetched = _fetch_decisions(decisions)
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
            slot.events = ["admit"]
            slot.last_token = tok
            slot.pos = p_len
            slot.active = True
            slot.seq += 1            # late replies of the predecessor drop
            slot.pending = {}
            slot.draft = []
            slot.miss_streak = 0
            slot.standalone = False
            slot.admit_seq = self._next_admit_seq()
            slot.cloud_pkts = []
            admitted = True
            self._maybe_finish(slot)
        return admitted

    def _admit_chunked(self, slot: _Slot, req: Request, prompt: np.ndarray,
                       hit, hit_pages: int, terminal) -> None:
        """Chunked admission: map the shared-prefix pages, allocate the
        remaining prompt pages now (mid-prefill slots are not
        preemptible, so they must never allocate mid-flight), then either
        emit the memoized first token (a whole-prompt *terminal* hit: no
        prefill compute) or arm the slot's prefill state machine, which
        ``tick`` advances one page-sized chunk at a time."""
        pool, ps = self.pool, self.pool.page_size
        p_len = len(prompt)
        st = GenStats()
        n_full_shared = min(hit_pages, len(hit.pages)) if hit else 0
        shared = list(hit.pages[:n_full_shared]) if hit else []
        for lp, page in enumerate(shared):
            pool.share_page(slot.index, lp, page)
        tail_page = terminal[0] if terminal is not None else None
        if tail_page is not None:
            pool.share_page(slot.index, len(shared), tail_page)
        hit_toks = p_len if terminal is not None else n_full_shared * ps
        if hit_toks:
            pool.stats.prefix_hit_tokens += hit_toks
            st.prefix_hit_tokens += hit_toks
            if self.mode == "collm":
                # dedup ledger: these prompt positions never cross the wire
                self.cm.note_prefix_reuse(req.device_id, hit_toks)
        first_alloc = len(shared) + (1 if tail_page is not None else 0)
        for lp in range(first_alloc, pages_needed(p_len, ps)):
            self._alloc_page(slot.index, lp)
        if self._prefix_share:
            # register this prompt's full chunks in the radix trie NOW
            # (unfilled): a prompt admitted next tick maps them already
            # and stalls until this stream's chunk compute fills them
            pool.insert_prefix(slot.index, [int(t) for t in prompt])
        self._tbl_device = None
        slot.req, slot.stats = req, st
        slot.pending = {}
        slot.draft = []
        slot.miss_streak = 0
        slot.standalone = False
        slot.admit_seq = self._next_admit_seq()
        slot.cloud_pkts = []
        slot.seq += 1
        slot.active = True
        slot.prefill_wait = []
        slot.prefill_wait_cloud = []
        if terminal is not None:
            # the memoized greedy first token stands in for the whole
            # prefill: exit decisions and cloud logits are deterministic
            # functions of the (identical) prompt
            tok = int(terminal[1])
            st.tokens = 1
            slot.tokens = [tok]
            slot.emit_ts = [self.vnow]
            slot.events = ["admit"]
            slot.last_token = tok
            slot.pos = p_len
            slot.prefill_prompt = None
            return
        slot.tokens = []
        slot.emit_ts = []
        slot.events = []
        slot.last_token = 0
        slot.pos = 0                 # meaningless until prefill completes
        slot.prefill_prompt = prompt
        slot.prefill_pos = n_full_shared * ps
        slot.prefill_wait = [p for p in shared if not pool.pages_filled([p])]
        if self._batcher is not None:
            b_shared = self._batcher.admit_begin(
                req.device_id, prompt, p_len, p_len + req.max_new,
                hit_pages=n_full_shared)
            slot.prefill_wait_cloud = [
                p for p in b_shared if not self._batcher.pages_filled([p])]

    def _prefill_tick(self, s: _Slot) -> None:
        """Advance one mid-prefill slot by ONE page-sized chunk.  A sharer
        whose mapped shared pages are still being computed by their owning
        stream stalls (never deadlocks: the owner was admitted in an
        earlier tick or slot and advances every tick).  The final chunk
        yields the first-token decision exactly like monolithic admission
        (its decisions read back to the host in one copy), then the slot
        decodes."""
        pool = self.pool
        if s.prefill_wait:
            if not pool.pages_filled(s.prefill_wait):
                return
            s.prefill_wait = []
        if s.prefill_wait_cloud:
            if self._batcher is not None \
                    and not self._batcher.pages_filled(s.prefill_wait_cloud):
                return
            s.prefill_wait_cloud = []
        st, req = s.stats, s.req
        prompt = s.prefill_prompt
        p_len = len(prompt)
        ps = pool.page_size
        pos0 = s.prefill_pos
        clen = min(ps, p_len - pos0)
        dev = self.model.device
        chunk = torch.zeros((1, ps), dtype=torch.long, device=dev)
        chunk[0, :clen] = torch.as_tensor(prompt[pos0:pos0 + clen],
                                          device=dev)
        row_tbl = torch.tensor(pool.block_table[s.index:s.index + 1],
                               device=dev)
        t0 = time.perf_counter()
        decisions, h1, self.edge_caches = self.collm.edge_prefill_chunk(
            chunk, pos0, clen, self.edge_caches, row_tbl,
            with_logits=self.sampler != "greedy")
        st.edge_time += time.perf_counter() - t0
        st.prefill_chunks += 1
        final = pos0 + clen >= p_len
        prefill_logits = None
        if self.mode == "collm":
            t0 = time.perf_counter()
            if self._batcher is not None:
                logits = self._batcher.admit_chunk(req.device_id, h1, pos0,
                                                   clen)
            else:
                logits, self.cloud_caches = self.collm.cloud_prefill_chunk(
                    h1, pos0, clen, self.cloud_caches, row_tbl)
            st.cloud_time += time.perf_counter() - t0
            # only the suffix that is not shared crosses the wire, chunk by
            # chunk (the true chunk length, not the padded page: in sum
            # the monolithic upload of the same suffix)
            st.upload_bytes += hidden_wire_bytes(
                self.model.cfg.d_model, self.ccfg.wire_format, seq=clen)
            if final:
                prefill_logits = logits
        if clen == ps and self._prefix_share:
            pool.mark_filled(int(pool.block_table[s.index, pos0 // ps]))
        s.prefill_pos = pos0 + clen
        if not final:
            return
        tok = self._first_token(_fetch_decisions(decisions), prefill_logits,
                                st)
        st.tokens += 1
        s.prefill_prompt = None
        s.tokens = [tok]
        s.emit_ts = [self.vnow]
        s.events = ["admit"]
        s.last_token = tok
        s.pos = p_len
        if self._prefix_share and self._batcher is None:
            # terminal insertion at admission: a later identical prompt
            # reuses the partial tail page and this first token, and THIS
            # stream's own first decode write copies the now-shared tail
            pool.insert_terminal(s.index, [int(t) for t in prompt], tok)
        self._maybe_finish(s)

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
        into its stats at retirement: TTFT (first emission minus request
        arrival), inter-token gaps, and, when the request carries SLO
        targets, one met/total attainment sample."""
        st, req = slot.stats, slot.req
        ts = slot.emit_ts
        if not ts:
            return
        ttft = ts[0] - req.arrival_t
        st.ttft_s.append(ttft)
        gaps = [b - a for a, b in zip(ts, ts[1:])]
        st.token_lat_s.extend(gaps)
        if req.slo_ttft_s is not None or req.slo_tpot_s is not None:
            st.slo_total += 1
            met = True
            if req.slo_ttft_s is not None and ttft > req.slo_ttft_s:
                met = False
            if (req.slo_tpot_s is not None and gaps
                    and sum(gaps) / len(gaps) > req.slo_tpot_s):
                met = False
            st.slo_met += int(met)

    # -- slot retirement ----------------------------------------------------
    def _maybe_finish(self, slot: _Slot) -> bool:
        req = slot.req
        done = (len(slot.tokens) >= req.max_new
                or (req.eos_id is not None
                    and slot.tokens[-1] == req.eos_id))
        # speculative: the tail tokens stay provisional until their replies
        # reconcile (a rewind may resume decoding), and a buffered draft
        # must flush before the slot can retire
        done = done and not slot.pending and not slot.draft
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
        cloud reply (non-speculative) or has provisionally reached its end
        and awaits validation (speculative).  Mid-prefill slots never
        decode: ``_prefill_tick`` advances them instead."""
        if not s.active:
            return False
        if s.prefill_prompt is not None:
            return False
        if s.pending and not self._spec:
            return False
        if len(s.tokens) >= s.req.max_new:
            return False
        if (s.req.eos_id is not None and s.tokens
                and s.tokens[-1] == s.req.eos_id):
            return False
        return True

    def _free_pages(self, slot: _Slot) -> None:
        """Bulk-free a retired slot's pages and invalidate them on device
        (pos = -1) so reallocation can never leak its K/V.  Pages the radix
        prefix cache (or another slot) still references only lose one
        reference, stay resident and are NOT invalidated."""
        freed = self.pool.free_slot(slot.index)
        self._tbl_device = None
        self._reset_freed(freed)

    # -- preemption ---------------------------------------------------------
    # Admission is optimistic, so a decode-time alloc can find the free list
    # empty.  The scheduler then checkpoints a victim stream (tokens,
    # events, stats, pending ContentManager uploads, the cloud-consumed
    # upload packets, the CloudBatcher row) and frees its pages; the stream
    # resumes later by re-prefill of its token prefix ("recompute") or a
    # host round trip of its pages ("swap").  The resume point is always
    # ``len(prompt) + len(tokens) - 1``: the last emitted token is fed
    # again, so an interrupted edge pass simply runs again, and greedy
    # decode makes the rerun deterministic.

    def _preempt_victim(self, s: _Slot) -> None:
        """Pick and preempt one victim stream to free pages for ``s``.
        Shared (refcounted) pages do not come back on free, so victims are
        ranked by *reclaimable* pages; mid-prefill slots are excluded (they
        allocated everything at admission, and a checkpoint with no
        emitted token has no resume point)."""
        if self.preemption == "off":
            raise RuntimeError(
                f"slot {s.index}: out of pages mid-decode with preemption "
                f"off — the conservative admission check should make this "
                f"impossible")
        cands = [VictimCandidate(v.index, v.admit_seq,
                                 self.pool.owned_pages(v.index),
                                 self.pool.shared_pages(v.index))
                 for v in self.slots
                 if v.active and v is not s and v.prefill_prompt is None]
        try:
            victim = select_victim(cands, self.preempt_policy)
        except OutOfPages:
            raise RuntimeError(
                f"slot {s.index}: out of pages and no preemptible victim "
                f"(pool of {self.pool.num_pages} pages too small for one "
                f"stream?)") from None
        self._preempt(self.slots[victim])

    def _ensure_page(self, s: _Slot, lp: int) -> None:
        """Alloc-on-write with reclaim and preemption: evict prefix-cache
        pages nobody maps first, then keep freeing victims until the page
        for ``s``'s next write exists."""
        while True:
            try:
                self._alloc_page(s.index, lp)
                return
            except OutOfPages:
                self.oops += 1
                self._preempt_victim(s)

    def _cow_write(self, s: _Slot, lp: int) -> None:
        """Copy-on-write: ``s`` is about to write into a page another
        stream (or the radix cache) still references.  Allocate a private
        copy, copy the page on the device across every cache tree this
        engine holds (K, V, ``pos`` and int8 scales), and repoint the block
        table; co-holders keep reading the original."""
        while True:
            try:
                src, dst = self.pool.cow_page(s.index, lp)
                break
            except OutOfPages:
                self.oops += 1
                freed = self.pool.evict_prefix(1)
                if freed:
                    self._reset_freed(freed)
                    continue
                self._preempt_victim(s)
        self._tbl_device = None
        for tree in self._trees():
            _copy_pages_tree(tree, src, dst)
        s.stats.cow_copies += 1

    def _preempt(self, s: _Slot) -> None:
        """Checkpoint one active stream and free its slot and pages.

        In-flight cloud replies are abandoned (the ``seq`` bump makes them
        late-drop), and queued CloudBatcher requests are cancelled before
        any KV is released."""
        req, st = s.req, s.stats
        if (s.pending or s.draft) and self._spec:
            # provisional tokens past the earliest unvalidated position
            # would never be reconciled: cut the checkpoint back to the
            # validated prefix (the rerun speculates them again)
            cand = [p.tok_index for p in s.pending.values()]
            if s.draft:
                cand.append(s.draft[0].tok_index)
            cut = min(cand)
            for kind in reversed(s.events[cut:]):
                self._unwind_event(s, kind)
            del s.tokens[cut:]
            del s.emit_ts[cut:]
            del s.events[cut:]
        # abandoned waits are virtual time this stream really spent: bill
        # them here, because their replies will late-drop
        for pend in s.pending.values():
            if not self._spec:
                st.stall_s += self.vnow - pend.stall_from
            st.overlap_s += self._hidden_s(pend)
        s.pending = {}
        # dropped draft packets sit at or after the resume point: the rerun
        # uploads them again, so they are not checkpointed
        s.draft = []
        resume_pos = len(req.prompt) + len(s.tokens) - 1
        use_swap = self.preemption == "swap"
        if (use_swap and self._adaptive is not None
                and self._adaptive.cfg.adapt_resume_mode
                and self._resume_cost is not None):
            # per-victim mode choice: short contexts re-prefill cheaper
            # than their KV round-trips the host; long contexts flip
            use_swap = self._resume_cost.prefer_swap(
                resume_pos, int(resume_pos * self._kv_token_bytes()))
        # cloud KV at or after the resume point is rebuilt by the rerun;
        # everything before it replays from the consumed-upload log
        ck_pkts = [e for e in s.cloud_pkts if e[0] < resume_pos]
        uploads = []
        if self.mode == "collm":
            uploads = [u for u in self.cm.take_all_uploads(req.device_id)
                       if u[0] < resume_pos]
        batcher_swap = None
        if self._batcher is not None:
            if use_swap:
                batcher_swap = self._batcher.swap_out(req.device_id)
            else:
                self._batcher.release(req.device_id)
        swap_key, swap_pages = None, 0
        if self.pool is not None:
            if use_swap:
                swap_key, swap_pages = self._swap_out_slot(s)
            self._free_pages(s)
        self._preempted.append(_Checkpoint(
            req=req, stats=st, tokens=list(s.tokens), events=list(s.events),
            emit_ts=list(s.emit_ts), cloud_pkts=ck_pkts, uploads=uploads,
            standalone=s.standalone, miss_streak=s.miss_streak,
            swap_key=swap_key, swap_pages=swap_pages,
            batcher_swap=batcher_swap))
        st.preemptions += 1
        self.preemptions += 1
        s.seq += 1               # outstanding replies must never land here
        s.active = False
        s.req = None
        s.stats = None
        s.tokens = []
        s.emit_ts = []
        s.events = []
        s.cloud_pkts = []

    def _kv_token_bytes(self) -> float:
        """Device bytes of KV per resident token (paged layout: the pooled
        cache bytes over the pool's token capacity), the quantity the
        swap cost model prices per victim."""
        if self._kv_tok_bytes is None:
            cap = self.pool.num_pages * self.pool.page_size
            self._kv_tok_bytes = self.kv_cache_bytes() / max(1, cap)
        return self._kv_tok_bytes

    def _swap_out_slot(self, s: _Slot) -> tuple:
        """Copy the slot's physical pages (every cache tree this engine
        holds) to the host-side SwapPool; returns (key, n_pages)."""
        key = self._swap_key
        self._swap_key += 1
        logical, trees = np.zeros((0,), np.int32), {}
        for name in ("main_caches", "edge_caches", "cloud_caches"):
            c = getattr(self, name, None)
            if c is None:
                continue
            logical, t = gather_slot_pages(self.pool, s.index, c)
            if t is not None:
                trees[name] = t
        self.swap.put(key, {"logical": logical, "trees": trees or None})
        return key, len(logical)

    def _resume_preempted(self) -> bool:
        """Resume checkpointed streams, first in first out, into free slots
        while their pages (and, in collm mode, a cloud row) are
        available."""
        resumed = False
        while self._preempted:
            slot = next((s for s in self.slots
                         if not s.active and s.req is None), None)
            if slot is None or not self._resumable(self._preempted[0]):
                break
            self._resume(self._preempted.popleft(), slot)
            resumed = True
        return resumed

    def _resumable(self, ck: _Checkpoint) -> bool:
        req = ck.req
        p_len = len(req.prompt)
        if self._batcher is not None \
                and not self._batcher.can_admit(p_len + req.max_new):
            return False
        if self.pool is None:
            return True
        need = (ck.swap_pages if ck.swap_key is not None
                else pages_needed(p_len + len(ck.tokens) - 1,
                                  self.pool.page_size))
        return self._fits_now(need)

    def _resume_pad(self, length: int) -> int:
        """Prefill bucket for a resume prefix: the usual power-of-two
        bucket, clamped to the single-row cache capacity (the prefix itself
        always fits); the exact length for recurrent models."""
        if not self._pad_ok:
            return length
        return min(_bucket(length), self._row_seq)

    def _resume(self, ck: _Checkpoint, slot: _Slot) -> None:
        req = ck.req
        prompt = np.asarray(req.prompt, np.int32)
        resume_pos = len(prompt) + len(ck.tokens) - 1
        if self._resume_cost is not None:
            # bill the chosen resume mode's modelled cost into this
            # engine's virtual clock: static and adaptive configurations
            # pay the same physics, they only choose differently
            if ck.swap_key is not None:
                kv_bytes = int(ck.swap_pages * self.pool.page_size
                               * self._kv_token_bytes())
                self.vnow += self._resume_cost.swap_s(kv_bytes)
            else:
                self.vnow += self._resume_cost.recompute_s(resume_pos)
        if self.mode == "collm":
            self.cm.restore_uploads(req.device_id, ck.uploads)
        if ck.swap_key is not None:
            self._swap_in_slot(slot, self.swap.take(ck.swap_key))
            if self._batcher is not None:
                self._batcher.swap_in(req.device_id, ck.batcher_swap)
        else:
            self._reprefill(slot, ck, prompt, resume_pos)
        slot.req, slot.stats = req, ck.stats
        slot.tokens = list(ck.tokens)
        slot.emit_ts = list(ck.emit_ts)
        slot.events = list(ck.events)
        slot.last_token = ck.tokens[-1]
        slot.pos = resume_pos
        slot.active = True
        slot.seq += 1
        slot.pending = {}
        slot.draft = []
        slot.miss_streak = ck.miss_streak
        slot.standalone = ck.standalone
        slot.cloud_pkts = list(ck.cloud_pkts)
        slot.admit_seq = self._next_admit_seq()
        self._maybe_finish(slot)

    def _swap_in_slot(self, slot: _Slot, snap: dict) -> None:
        """Write a swap snapshot into freshly allocated physical pages and
        bind them in the slot's block table (pages are row-agnostic)."""
        if snap["trees"] is None or not len(snap["logical"]):
            return
        short = len(snap["logical"]) - self.pool.free_pages
        if short > 0:       # reclaim cached prefix pages for the rebind
            self._reset_freed(self.pool.evict_prefix(short))
        padded = rebind_slot_pages(self.pool, slot.index, snap["logical"])
        self._tbl_device = None
        trees = snapshot_to_device(snap["trees"], self.model.device)
        for name, data in trees.items():
            _write_pages_tree(getattr(self, name), padded, data)

    def _reprefill(self, slot: _Slot, ck: _Checkpoint, prompt: np.ndarray,
                   resume_pos: int) -> None:
        """Recompute resume: one prefill over ``prompt + tokens[:-1]``
        rebuilds the edge (or full-model) KV, and the checkpointed
        consumed-upload log replays the cloud KV — gaps at early-exited
        positions included, as the unpreempted run left them."""
        dev = self.model.device
        p_len = len(prompt)
        st = ck.stats
        pad = self._resume_pad(resume_pos)
        tokens = torch.zeros((1, pad), dtype=torch.long, device=dev)
        tokens[0, :p_len] = torch.as_tensor(prompt, device=dev)
        tokens[0, p_len:resume_pos] = torch.as_tensor(ck.tokens[:-1],
                                                      device=dev)
        pages = (self._admit_pages(slot, resume_pos, pad)
                 if self.pool is not None else None)
        if self.mode == "cloud":
            t0 = time.perf_counter()
            _, row = self.collm.full_prefill_padded(tokens, resume_pos,
                                                    self._full_row0)
            self.main_caches = self._scatter_admit(self.main_caches, row,
                                                   slot, pages)
            st.cloud_time += time.perf_counter() - t0
            return
        t0 = time.perf_counter()
        _, h1_seq, row = self.collm.edge_prefill_padded(tokens, resume_pos,
                                                        self._edge_row0)
        self.edge_caches = self._scatter_admit(self.edge_caches, row, slot,
                                               pages)
        st.edge_time += time.perf_counter() - t0
        if self.mode != "collm":
            return
        # the cloud's prompt prefill (the admission's padded hidden slice)
        # and a replay of the consumed decode uploads; the re-prefill's
        # hidden is not uploaded again: the wire carried it before
        t0 = time.perf_counter()
        h1_p = h1_seq[:, :self._resume_pad(p_len)]
        dev_id = ck.req.device_id
        if self._batcher is not None:
            self._batcher.admit(dev_id, h1_p, p_len, p_len + ck.req.max_new)
            self._batcher.restore(dev_id, ck.cloud_pkts)
        else:
            cpages = None
            if self.pool is not None:
                n_prompt = pages_needed(p_len, self.pool.page_size)
                cpages = np.full((pages_needed(h1_p.shape[1],
                                               self.pool.page_size),),
                                 -1, np.int32)
                cpages[:n_prompt] = self.pool.block_table[slot.index,
                                                          :n_prompt]
            _, crow = self.collm.cloud_prefill_padded(h1_p, p_len,
                                                      self._cloud_row0)
            self.cloud_caches = self._scatter_admit(self.cloud_caches, crow,
                                                    slot, cpages)
            self._replay_cloud(slot, ck.cloud_pkts)
        st.cloud_time += time.perf_counter() - t0

    def _replay_cloud(self, slot: _Slot, pkts: List[tuple]) -> None:
        """Own-cloud replay of the checkpointed consumed uploads (one
        masked ring pass over this slot's row)."""
        if not pkts:
            return
        ring, ring_pos, valid = build_upload_ring([(slot.index, pkts)],
                                                  self.B)
        _, self.cloud_caches = self.collm.ring_cloud_steps(
            ring, ring_pos, valid, self.cloud_caches, self._block_tbl())

    # -- one decode tick ----------------------------------------------------
    def tick(self) -> None:
        """One step of the two-stage pipeline: resolve due replies, run the
        edge pass for every row, dispatch this tick's below-θ cloud
        requests, resolve again (a ``SyncChannel`` reply arrives within
        the same tick).  When every active row waits on the channel, the
        virtual clock jumps to the next arrival or deadline instead."""
        self._tick_no += 1
        if self._adaptive is not None:
            self._adaptive.on_tick(self._tick_no, self.pool,
                                   self.preemptions, self.oops)
        for idx in self._preempt_schedule.get(self._tick_no, ()):
            # forced preemption (mid-prefill slots are never preemptible:
            # they have no resume point yet)
            if (self.slots[idx].active
                    and self.slots[idx].prefill_prompt is None):
                self._preempt(self.slots[idx])
        self._resolve()
        # chunked prefill: every mid-prefill slot advances by ONE
        # page-sized chunk per tick, interleaved with the other slots'
        # decode below (sharers stalled on unfilled pages just wait)
        prefilling = [s for s in self.slots
                      if s.active and s.prefill_prompt is not None]
        for s in prefilling:
            self._prefill_tick(s)
        busy = {s.index for s in prefilling}
        runnable = [s for s in self.slots
                    if self._runnable(s) and s.index not in busy]
        if not runnable:
            # a prefill chunk IS progress: do not jump the virtual clock
            if any(s.active for s in self.slots) and not prefilling:
                self._advance_idle()
                self._resolve()
            return
        if self.pool is not None:
            for s in runnable:
                if not s.active:
                    continue
                # alloc-on-write: this tick writes KV at s.pos; an empty
                # free list preempts a victim stream (never s itself).  A
                # mapped but shared page (radix prefix or cached terminal
                # tail) is split before the write: copy-on-write
                lp = s.pos // self.pool.page_size
                page = self.pool.block_table[s.index, lp]
                if page == -1:
                    self._ensure_page(s, lp)
                elif self.pool.is_shared(int(page)):
                    self._cow_write(s, lp)
            runnable = [s for s in runnable if s.active]  # minus victims
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
            self._emit(s, int(next_tok[s.index]), "full")

    def _tick_edge(self, runnable, tokens, pos) -> None:
        collm, ccfg = self.collm, self.ccfg
        greedy = self.sampler == "greedy"
        t0 = time.perf_counter()
        if self._mask_edge:
            run_mask = torch.zeros((self.B,), dtype=torch.bool,
                                   device=tokens.device)
            run_mask[[s.index for s in runnable]] = True
            out = collm.edge_step_masked(tokens, self.edge_caches, pos,
                                         run_mask, self._block_tbl(),
                                         with_logits=not greedy)
        else:
            out = collm.edge_step(tokens, self.edge_caches, pos,
                                  self._block_tbl(), with_logits=not greedy)
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
                    self._emit(s, int(tok2[s.index]), "l1")
                else:
                    s.stats.exits_l2 += 1
                    self._emit(s, int(tok2[s.index]), "l2")
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
        if self._spec:
            # below-θ rows buffer provisional tokens and ship them in
            # k-token verification requests (spec_k=1: one a request)
            self._draft_tick(needy, uploaders, tok2)
        elif needy:
            self._dispatch_cloud(needy, pos, tok2)
        for s in runnable:
            if exited[s.index]:
                if s.stats.confidences[-1][0] >= ccfg.theta:
                    s.stats.exits_l1 += 1
                    self._emit(s, int(exit_toks[s.index]), "l1")
                else:
                    s.stats.exits_l2 += 1
                    self._emit(s, int(exit_toks[s.index]), "l2")
            elif s.standalone:
                # latency fallback: the edge serves its below-θ tokens
                s.stats.exits_l2 += 1
                self._emit(s, int(tok2[s.index]), "l2")
            # else: needy — the token arrives via the channel (_resolve),
            # or was committed provisionally by _draft_tick

    def _masked_cloud(self, rows: List[int], pkts: List[StatePacket],
                      pos: torch.Tensor) -> torch.Tensor:
        """One masked cloud step over the pool: ``pkts[i]`` is row
        ``rows[i]``'s upload at position ``pos[rows[i]]``; the other rows'
        caches stay as they were.  The (B, ...) input is built on the
        device by index copies.  Returns the (B, V) logits."""
        dev = self.model.device
        idx = torch.as_tensor(rows, device=dev)
        dense = {}
        for k, v in pkts[0].hidden.items():
            dense[k] = torch.zeros((self.B,) + tuple(v.shape[1:]),
                                   dtype=v.dtype, device=dev)
            dense[k][idx] = torch.cat([p.hidden[k] for p in pkts])
        mask = torch.zeros((self.B,), dtype=torch.bool, device=dev)
        mask[idx] = True
        logits, self.cloud_caches = self.collm.cloud_step(
            dense, self.cloud_caches, pos, block_tbl=self._block_tbl(),
            write_mask=mask)
        return logits

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
        # the consumed-upload log backs the recompute resume's cloud
        # replay; a swap resume restores pages directly
        track = self.preemption == "recompute"
        t0 = time.perf_counter()
        if self._batcher is not None:
            payloads = {}
            for s in needy:
                group, row, consumed = self._batcher.submit(
                    s.req.device_id, s.pos, backfill=ccfg.backfill)
                payloads[s.index] = (group, row)
                if track:
                    s.cloud_pkts.extend(consumed)
        else:
            if ccfg.backfill:
                rings = self.cm.take_uploads_upto_batch(
                    [(s.req.device_id, s.pos) for s in needy])
                if track:
                    for s, pend in zip(needy, rings):
                        s.cloud_pkts.extend(pend)
                ring, ring_pos, valid = build_upload_ring(
                    [(s.index, pend) for s, pend in zip(needy, rings)],
                    self.B)
                logits, self.cloud_caches = self.collm.ring_cloud_steps(
                    ring, ring_pos, valid, self.cloud_caches,
                    self._block_tbl())
            else:
                pkts = self.cm.take_upload_batch(
                    [(s.req.device_id, s.pos) for s in needy])
                if track:
                    for s, pkt in zip(needy, pkts):
                        s.cloud_pkts.append((s.pos, pkt))
                logits = self._masked_cloud(
                    [s.index for s in needy], pkts, pos)
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
        self._block_on(handles)

    def _block_on(self, handles: List[int]) -> None:
        """``overlap=False``, the blocking baseline: the whole pool waits
        for these replies (still paying the channel's virtual latency); the
        jump is pure idle time, nothing decodes during it."""
        if self.overlap:
            return
        arr = [self.channel.arrival_of(h) for h in handles]
        target = max([self.vnow] + [a for a in arr if a is not None])
        self._idle_s += target - self.vnow
        self.vnow = target

    # -- multi-token drafting (speculative path) ----------------------------
    def _draft_tick(self, needy: List[_Slot], uploaders: List[_Slot],
                    prov_toks: np.ndarray) -> None:
        """Speculative drafting: every below-θ row commits its provisional
        l_ee2 token into the slot's draft buffer — popping the
        just-uploaded packet so that the ContentManager window can never
        release a position still awaiting verification — then full
        drafts, drafts whose row took a confident tick (drafts stay
        position-contiguous), and drafts whose row just reached its end
        flush as single verification requests (``_flush_drafts``)."""
        needy_idx = set()
        for s in needy:
            needy_idx.add(s.index)
            dev = s.req.device_id
            # release mode consumes the position (releasing the earlier
            # confident-tick uploads); backfill keeps those for the flush
            pkt = (self.cm.take_upload_keep(dev, s.pos) if self.ccfg.backfill
                   else self.cm.take_upload(dev, s.pos))
            s.draft.append(_DraftTok(
                pos=s.pos, tok_index=len(s.tokens),
                provisional=int(prov_toks[s.index]), pkt=pkt))
            # latency hiding: commit the edge token provisionally and keep
            # decoding; the verification reply reconciles it (_resolve)
            self._emit(s, int(prov_toks[s.index]), "spec")
        flush = []
        for s in uploaders:
            if not s.draft:
                continue
            eos = s.req.eos_id
            at_end = (len(s.tokens) >= s.req.max_new
                      or (eos is not None and s.tokens[-1] == eos))
            if (len(s.draft) >= self._spec_k
                    or s.index not in needy_idx   # a confident tick ends it
                    or at_end):                   # the row won't tick again
                flush.append(s)
        if flush:
            self._flush_drafts(flush)

    def _flush_drafts(self, rows: List[_Slot]) -> None:
        """Ship each row's buffered draft as ONE verification request: the
        k draft packets form the row's upload ring (backfill also drains
        the older uploads not yet consumed, keeping the cloud KV exact) and
        one masked ring pass scores every draft position
        (``ring_cloud_steps_all``); the reply carries per-position logits
        for the accept-prefix reconcile.  A wave of single tokens (spec_k=1,
        release mode) takes the dense masked step."""
        ccfg = self.ccfg
        track = self.preemption == "recompute"
        t0 = time.perf_counter()
        ring_maps: Dict[int, Dict[int, int]] = {}
        if self._batcher is not None:
            payloads = {}
            for s in rows:
                group, row, consumed = self._batcher.submit_draft(
                    s.req.device_id, [(d.pos, d.pkt) for d in s.draft],
                    backfill=ccfg.backfill)
                payloads[s.index] = (group, row)
                ring_maps[s.index] = {p: i for i, (p, _)
                                      in enumerate(consumed)}
                if track:
                    s.cloud_pkts.extend(consumed)
        else:
            entries = []
            for s in rows:
                pkt_list = [(d.pos, d.pkt) for d in s.draft]
                if ccfg.backfill:
                    # a confident tick flushes, so drafts are contiguous:
                    # every older upload not yet consumed precedes them
                    pkt_list = self.cm.take_uploads_upto(
                        s.req.device_id, s.draft[-1].pos) + pkt_list
                if track:
                    s.cloud_pkts.extend(pkt_list)
                entries.append((s.index, pkt_list))
                ring_maps[s.index] = {p: i for i, (p, _)
                                      in enumerate(pkt_list)}
            if max(len(pl) for _, pl in entries) == 1 and not ccfg.backfill:
                # a wave of single tokens: the dense masked step (the
                # classic speculative dispatch)
                posv = np.zeros((self.B,), np.int32)
                for s in rows:
                    posv[s.index] = s.draft[0].pos
                logits = self._masked_cloud(
                    [s.index for s in rows], [pl[0][1] for _, pl in entries],
                    torch.as_tensor(posv, device=self.model.device))
                all_logits = None
            else:
                ring, ring_pos, valid = build_upload_ring(entries, self.B)
                logits, all_logits, self.cloud_caches = \
                    self.collm.ring_cloud_steps_all(
                        ring, ring_pos, valid, self.cloud_caches,
                        self._block_tbl())
            group = {"logits": logits, "all": all_logits, "np": None,
                     "np_all": None}
            payloads = {s.index: (group, s.index) for s in rows}

        dt = (time.perf_counter() - t0) / len(rows)
        handles = []
        for s in rows:
            s.stats.cloud_time += dt
            kk = len(s.draft)
            rm = ring_maps[s.index]
            for d in s.draft:
                d.ring_idx = rm[d.pos]
            # wire: the k hidden rows were billed by their per-tick uploads;
            # the request carries the k provisional ids up and k verified
            # ids down
            h = self.channel.submit(
                slot=s.index, seq=s.seq, pos=s.draft[-1].pos,
                reply=payloads[s.index], now=self.vnow,
                nbytes_up=draft_request_bytes(kk),
                nbytes_down=TOKEN_BYTES * kk)
            s.pending[h] = _Pending(
                pos=s.draft[-1].pos, tok_index=s.draft[0].tok_index,
                provisional=s.draft[0].provisional, stall_from=self.vnow,
                deadline_t=self.vnow + self.channel.deadline_s,
                idle_at=self._idle_s, draft=s.draft)
            s.stats.draft_tokens += kk
            s.draft = []
            handles.append(h)
        self._block_on(handles)

    def _draft_tokens(self, rep) -> np.ndarray:
        """A verification reply's per-position greedy tokens for this row,
        shape (depth,); each draft entry's ``ring_idx`` indexes it.  The
        argmax runs on the device over the group's (depth, B, V) logits,
        once a group; only the (depth, B) tokens are copied to the host."""
        group, row = rep.reply
        if group.get("np_all") is None:
            if group["logits"] is None and group.get("all") is None:
                # lazy CloudBatcher wave: the first materialization
                # computes it
                group["flush"]()
            if group.get("all") is not None:
                group["np_all"] = group["all"].argmax(dim=-1).cpu().numpy()
            else:
                # a wave of single tokens: the final logits, depth 1
                group["np_all"] = group["logits"].argmax(
                    dim=-1)[None, :].cpu().numpy()
        return group["np_all"][:, row]

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
        if self._spec:
            # the whole edge draft becomes final: every position the reply
            # would have reconciled commits as an l2 exit
            for d in pend.draft:
                s.events[d.tok_index] = "l2"
                s.stats.exits_l2 += 1
        else:
            s.stats.stall_s += self.vnow - pend.stall_from
            s.stats.overlap_s += self._hidden_s(pend)
            s.stats.exits_l2 += 1
            self._emit(s, pend.provisional, "l2")
        if (self.fallback_after
                and s.miss_streak >= self.fallback_after
                and not s.standalone):
            s.standalone = True
            s.stats.fallbacks += 1
            # a buffered draft can never flush once the row stops
            # uploading: its provisional tokens become final l2 exits,
            # never billed as draft_tokens
            for d in s.draft:
                s.events[d.tok_index] = "l2"
                s.stats.exits_l2 += 1
            s.draft = []

    def _resolve(self) -> None:
        """Drain the replies that have arrived by the current virtual time,
        then expire deadlines."""
        for rep in self.channel.poll(self.vnow):
            s = self.slots[rep.slot] if rep.slot < self.B else None
            if (s is None or not s.active or s.seq != rep.seq
                    or rep.handle not in s.pending):
                # the slot retired, was refilled, or rewound past this
                # position: a late reply must never land on its successor
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
            if self._spec:
                s.stats.overlap_s += self._hidden_s(pend)
                s.miss_streak = 0
                toks = self._draft_tokens(rep)
                accepted = 0
                for d in pend.draft:
                    cloud_tok = int(toks[d.ring_idx])
                    if cloud_tok == s.tokens[d.tok_index]:
                        # validated: the provisional token IS the cloud's
                        s.events[d.tok_index] = "cloud"
                        s.stats.cloud_requests += 1
                        s.stats.accepted_tokens += 1
                        accepted += 1
                    else:
                        # first disagreement: correct it and discard the
                        # rejected suffix (later positions were scored on
                        # a wrong token)
                        self._rewind(s, d, cloud_tok)
                        break
                s.stats.accept_lens.append(accepted)
            else:
                tok = self._reply_token(rep)
                s.stats.cloud_requests += 1
                s.stats.stall_s += self.vnow - pend.stall_from
                s.stats.overlap_s += self._hidden_s(pend)
                s.miss_streak = 0
                self._emit(s, tok, "cloud")
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
        if self._arrival_hint is not None and self._arrival_hint > self.vnow:
            # open-loop replay: a queued request's future arrival is also
            # a wake-up point (a free slot may admit it before any reply
            # lands; jumping past it would inflate its queueing delay)
            cands.append(self._arrival_hint)
        cands = [t for t in cands if t != math.inf]
        if not cands:
            raise RuntimeError(
                "scheduler wedged: every row is blocked on the channel but "
                "it has nothing in flight and no finite deadline")
        target = max(self.vnow, min(cands))
        self._idle_s += target - self.vnow     # nothing decodes while idle
        self.vnow = target

    def _unwind_event(self, s: _Slot, kind: str) -> None:
        """Undo one discarded token's contribution to the per-stream
        counters (rewind, preemption cut).  ``deadline_misses`` is an event
        count, not a token property: it stays."""
        st = s.stats
        st.tokens -= 1
        if st.confidences:
            st.confidences.pop()
        if kind == "l1":
            st.exits_l1 -= 1
        elif kind == "l2":
            st.exits_l2 -= 1
        elif kind == "cloud":
            st.cloud_requests -= 1

    def _rewind(self, s: _Slot, pend: _DraftTok, tok: int) -> None:
        """Speculative reconcile: the cloud disagreed with the provisional
        token at ``pend.tok_index`` (``pend``: the ``_DraftTok``) — replace
        it, discard everything the row decoded after it, and invalidate the
        discarded cloud KV (a position the re-decoded stream never serves
        from the cloud again must read a gap, not stale K/V; edge KV needs
        no repair, decode overwrites a slot before reading it)."""
        i = pend.tok_index
        for kind in reversed(s.events[i + 1:]):
            self._unwind_event(s, kind)
        del s.tokens[i + 1:]
        del s.emit_ts[i + 1:]
        del s.events[i + 1:]
        s.tokens[i] = tok
        s.emit_ts[i] = self.vnow   # the corrected token streams out now
        s.events[i] = "cloud"
        s.stats.cloud_requests += 1
        s.stats.spec_rewinds += 1
        s.last_token = tok
        s.pos = pend.pos + 1
        for h, p2 in list(s.pending.items()):
            if p2.pos > pend.pos:      # requests of discarded positions
                del s.pending[h]       # (their replies will late-drop)
        # buffered draft tokens of discarded positions go too (a buffered
        # draft is always newer than any dispatched group)
        s.draft = [d for d in s.draft if d.pos <= pend.pos]
        # the invalidated cloud KV must not come back through a later
        # preemption replay either
        s.cloud_pkts = [e for e in s.cloud_pkts if e[0] <= pend.pos]
        # nor may the discarded positions' uploads stay in the upload
        # window: eight of them would release every new upload below them
        # before its draft takes it (the JAX package raises KeyError there)
        self.cm.drop_uploads_after(s.req.device_id, pend.pos)
        if self._batcher is not None:
            # drop the discarded positions' queued requests FIRST (a later
            # flush would write the KV being invalidated again)
            self._batcher.cancel(s.req.device_id, pend.pos + 1)
            self._batcher.invalidate(s.req.device_id, pend.pos + 1)
        else:
            cut = np.full((self.B,), np.iinfo(np.int32).max, np.int32)
            cut[s.index] = pend.pos + 1
            self.cloud_caches = self.collm.invalidate_rows_after(
                self.cloud_caches, cut, self._block_tbl())

    def _emit(self, slot: _Slot, tok: int, event: str) -> None:
        slot.tokens.append(tok)
        slot.emit_ts.append(self.vnow)
        slot.events.append(event)
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
            # arrival stamps are relative to the trace start: rebase them
            # onto this engine's (possibly reused) virtual clock
            r.arrival_t += self.vnow
        # open-loop replay admits in arrival order; the sort is stable, so
        # the closed-loop default (every arrival_t == 0) keeps submission
        # order
        queue = collections.deque(
            sorted(requests, key=lambda r: (r.arrival_t, r.index)))
        results: List[Optional[List[int]]] = [None] * len(requests)
        stats: List[Optional[GenStats]] = [None] * len(requests)
        v0 = self.vnow
        self.late_drops = 0
        self._tick_no = 0        # forced-preemption schedules are per run
        # a reused channel must not leak the previous run's link/service
        # virtual times (or stale in-flight replies) into this run's trace
        self.channel.reset()
        while queue or self._preempted or any(s.active for s in self.slots):
            self._arrival_hint = queue[0].arrival_t if queue else None
            admitted = self._admit(queue)
            self._collect(results, stats)     # finished at admission
            if any(s.active for s in self.slots):
                self.tick()
                self._collect(results, stats)
            elif (queue or self._preempted) and not admitted:
                if queue and queue[0].arrival_t > self.vnow:
                    # open-loop gap: nothing running and the next request
                    # has not arrived; jump the clock there (pure idle)
                    self._idle_s += queue[0].arrival_t - self.vnow
                    self.vnow = queue[0].arrival_t
                    continue
                # nothing active, nothing admitted or resumed, yet work
                # remains: no tick can ever free pages (an idle pool
                # resumes ignoring the watermark; an admission that
                # finished instantly sets ``admitted`` and refills)
                raise RuntimeError(
                    f"scheduler wedged: {len(queue)} queued, "
                    f"{len(self._preempted)} preempted, 0 active, "
                    f"pool {self.pool and self.pool.free_pages} pages free")
        # replies still in flight belong to retired slots — discard them
        self.late_drops += self.channel.drop_in_flight()
        self._arrival_hint = None
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
            r.arrival_t += s.vnow     # rebase trace time onto engine clock
        queues.append(collections.deque(
            sorted(reqs, key=lambda r: (r.arrival_t, r.index))))
    results = [[None] * len(rs) for rs in request_lists]
    stats = [[None] * len(rs) for rs in request_lists]
    v0 = [s.vnow for s in scheds]
    services = {}
    for s in scheds:
        s.late_drops = 0
        s._tick_no = 0
        s.channel.reset()
        svc = getattr(s.channel, "service", None)
        if svc is not None:
            services[id(svc)] = svc
    for svc in services.values():
        svc.reset()      # a shared point resets once per run, not per channel

    def busy(i: int) -> bool:
        return (bool(queues[i]) or bool(scheds[i]._preempted)
                or any(sl.active for sl in scheds[i].slots))

    while any(busy(i) for i in range(len(scheds))):
        progressed = False
        for i, s in enumerate(scheds):
            if not busy(i):
                continue
            s._arrival_hint = (queues[i][0].arrival_t if queues[i]
                               else None)
            progressed |= s._admit(queues[i])
            s._collect(results[i], stats[i])
            if any(sl.active for sl in s.slots):
                s.tick()
                s._collect(results[i], stats[i])
                progressed = True
            elif queues[i] and queues[i][0].arrival_t > s.vnow:
                # open-loop gap: this engine is empty until its next
                # arrival; jumping its private clock there IS progress
                s._idle_s += queues[i][0].arrival_t - s.vnow
                s.vnow = queues[i][0].arrival_t
                progressed = True
        if not progressed:
            raise RuntimeError(
                "multi-engine scheduler wedged: requests queued but no "
                "engine can admit or tick (shared cloud slots or pages "
                "exhausted with nothing running?)")
    for s, v in zip(scheds, v0):
        s.late_drops += s.channel.drop_in_flight()
        s._arrival_hint = None
        s.last_virtual_time = s.vnow - v
    makespan = max(s.last_virtual_time for s in scheds)
    return results, stats, makespan


def _fetch_decisions(decisions) -> Dict[int, tuple]:
    """Row 0 of each exit's decision as {layer: (token, confidence,
    logits)}: the tokens and confidences read back to the host in ONE
    copy (float64 holds both exactly); the logits stay on the device."""
    layers = sorted(decisions)
    host = torch.stack([v for l in layers
                        for v in (decisions[l].token[0].double(),
                                  decisions[l].confidence[0].double())]
                       ).cpu().tolist()
    return {l: (int(host[2 * i]), host[2 * i + 1], decisions[l].logits)
            for i, l in enumerate(layers)}


class ServingSystem:
    """End-to-end multi-client co-inference on the model's device; under
    ``CollmConfig.cloud_mesh`` on this rank's share of the model, every
    run ending in a check that all ranks emitted the same streams."""

    def __init__(self, model: Model, ccfg: CollmConfig = CollmConfig()):
        self.ccfg = ccfg
        self.collm = CoLLM(model, ccfg)
        # under a cloud mesh, this rank's share of ``model``
        self.model = self.collm.model
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
                 adaptive: Optional[AdaptiveConfig] = None,
                 resume_cost: Optional[ResumeCostModel] = None
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
        ``seed``.  Under ``CollmConfig.preemption != "off"`` the paged pool
        admits optimistically and preempts victims when pages run dry;
        ``watermark`` holds that many free pages back from admission as
        decode headroom, and ``preempt_schedule`` ([(tick, slot), ...])
        forces preemptions of given slots at given ticks.

        Open-loop replay: ``arrivals`` stamps one virtual arrival time per
        prompt (admission waits for it); ``slo_ttft_s`` / ``slo_tpot_s``
        arm per-request SLO targets the stats fold into
        ``slo_attainment``; ``adaptive`` turns on the engine's control
        loops and ``resume_cost`` prices preemption resumes into the
        virtual clock (both arms of a static-against-adaptive comparison
        should share one ``ResumeCostModel``).  Returns the JAX package's
        result keys."""
        if arrivals is not None and len(arrivals) != len(prompts):
            raise ValueError(f"need one arrival time per prompt "
                             f"({len(arrivals)} != {len(prompts)})")
        slots = num_slots or max(1, min(len(prompts), 8))
        longest = max(len(p) for p in prompts)
        max_seq = max_seq or (longest + max_new + 8)
        max_seq = max(max_seq, _bucket(longest))
        sched_tuple = (tuple((int(t), int(i)) for t, i in preempt_schedule)
                       if preempt_schedule else None)
        key = (mode, slots, max_seq, sampler, temperature, top_k, seed,
               max_ctx, num_pages,
               id(channel) if channel is not None else None,
               tick_time_s, overlap, fallback_after, watermark, sched_tuple,
               dataclasses.astuple(adaptive) if adaptive is not None
               else None,
               dataclasses.astuple(resume_cost) if resume_cost is not None
               else None)
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
                preempt_schedule=sched_tuple, adaptive=adaptive,
                resume_cost=resume_cost)
            self._schedulers[key] = sched
        reqs = [Request(device_id=f"edge-{i}", prompt=np.asarray(p),
                        max_new=max_new, eos_id=eos_id,
                        arrival_t=(float(arrivals[i])
                                   if arrivals is not None else 0.0),
                        slo_ttft_s=slo_ttft_s, slo_tpot_s=slo_tpot_s)
                for i, p in enumerate(prompts)]
        results, stats = sched.run(reqs)
        self.collm.mesh_ctx.check_streams(results)
        return {"tokens": results, "stats": _aggregate(stats),
                "per_client": stats, "cm_stats": self.cloud.cm.stats(),
                "num_slots": slots,
                "virtual_time": sched.last_virtual_time,
                "late_drops": sched.late_drops,
                "channel_stats": sched.channel.stats.as_row(),
                "preemptions": sched.preemptions, "oops": sched.oops,
                "adaptive": (sched._adaptive.as_row()
                             if sched._adaptive is not None else None),
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
        the default is a ``SyncChannel`` each.  ``preempt_schedules``
        gives each engine its ``preempt_schedule`` (or None).
        ``arrivals`` / ``slo_ttft_s`` / ``slo_tpot_s`` mirror
        ``generate()``: each engine admits its requests in arrival order.
        Returns the JAX package's result keys, with ``n_engines`` and, in
        cloud-batch mode, the batcher's stats row."""
        n = n_engines or len(prompts)
        if channels is not None and len(channels) != n:
            raise ValueError(f"need one channel per engine "
                             f"({len(channels)} != {n})")
        if arrivals is not None and len(arrivals) != len(prompts):
            raise ValueError(f"need one arrival time per prompt "
                             f"({len(arrivals)} != {len(prompts)})")
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
            fallback_after=fallback_after, cloud_batcher=batcher,
            preempt_schedule=(preempt_schedules[i]
                              if preempt_schedules is not None else None))
            for i in range(n)]
        per_engine = [[] for _ in range(n)]
        assign = [[] for _ in range(n)]
        for j, p in enumerate(prompts):
            per_engine[j % n].append(Request(
                device_id=f"edge-{j}", prompt=np.asarray(p),
                max_new=max_new, eos_id=eos_id,
                arrival_t=(float(arrivals[j])
                           if arrivals is not None else 0.0),
                slo_ttft_s=slo_ttft_s, slo_tpot_s=slo_tpot_s))
            assign[j % n].append(j)
        results, stats, makespan = run_multi(scheds, per_engine)
        tokens: List[Optional[List[int]]] = [None] * len(prompts)
        flat: List[Optional[GenStats]] = [None] * len(prompts)
        for e in range(n):
            for k, j in enumerate(assign[e]):
                tokens[j] = results[e][k]
                flat[j] = stats[e][k]
        self.collm.mesh_ctx.check_streams(tokens)
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
        self.collm.mesh_ctx.check_streams(results)
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
