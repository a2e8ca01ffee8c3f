"""Host-level serving of the CE-CoLLM system: the sequential loop.

Port of the sequential half of ``repro.serving.engine``.  Topology (paper
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

``ServingSystem.generate_sequential`` runs one client at a time, batch 1,
one Python iteration per token — the reference the batched engine of the
JAX package is held token-identical to.  The batched ``BatchScheduler`` is
not ported yet (ROADMAP A.5).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.collm import CoLLM, CollmConfig
from repro_torch.core.content_manager import ContentManager
from repro_torch.core.exits import first_confident_exit
from repro_torch.core.transport import (TOKEN_BYTES, CloudChannel,
                                        StatePacket, SyncChannel,
                                        hidden_wire_bytes)
from repro_torch.models.transformer import Caches, Model


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


class ServingSystem:
    """End-to-end multi-client co-inference on the model's device."""

    def __init__(self, model: Model, ccfg: CollmConfig = CollmConfig()):
        self.model = model
        self.ccfg = ccfg
        self.collm = CoLLM(model, ccfg)
        self.cloud = CloudServer(self.collm)

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
