"""CE-CoLLM co-inference steps (paper §4.4, Algorithm 1).

Port of ``repro.core.collm`` for the sequential serving loop:

  * ``edge_step``        — edge partition (layers 1..l_ee2) with exits at
                           l_ee1/l_ee2; emits the quantized l_ee1 upload.
  * ``fused_exit_upload``— the l_ee1 exit decision and its int8 upload in
                           one ``exit_quant`` kernel launch.
  * ``cloud_step``       — cloud partition (layers l_ee1+1..L) continuing
                           from an uploaded hidden state; also backfills
                           the KV of early-exited tokens.
  * ``standalone_step``  — the paper's low-latency edge standalone mode.
  * ``full_step``        — undivided model (cloud-deployment baseline).

Exit decisions go through the ``exit_head`` kernel and the int8 wire format
through the ``quantize`` kernel.  KV caches are updated in place.  The
masked, ring, paged and fused steps of the batched engine are not ported
yet (ROADMAP A.5), and ``CoLLM`` raises for any ``CollmConfig`` field that
selects them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.exits import (ExitDecision, evaluate_exit,
                                    first_confident_exit)
from repro_torch.core.transport import FORMATS, dequantize, quantize
from repro_torch.kernels.exit_quant.ops import exit_quant
from repro_torch.models.blocks import BlockCtx
from repro_torch.models.transformer import Caches, Model


@dataclasses.dataclass(frozen=True)
class CollmConfig:
    theta: float = 0.8
    wire_format: str = "float16"      # paper: float16; beyond-paper: int8
    max_pending: int = 4              # upload ring size (fused mode)
    # Latency hiding (paper §4.4): the cloud computes for EVERY row and the
    # edge commits a *provisional* exit-head token without waiting — the
    # fused step gates cloud compute on all rows, and the batched engine
    # reconciles the provisional token against the cloud reply when it
    # arrives (keep on match, rewind-and-replace on mismatch, keep on
    # deadline miss).  Requires greedy decoding + attention-only models in
    # the batched path (rewind re-decodes positions).
    speculative: bool = False
    # Draft length of the speculative path: a below-θ row keeps committing
    # up to ``spec_k`` provisional exit tokens into one *draft*, then ships
    # the whole draft as a single verification request; the cloud scores
    # all k positions in ONE masked ring pass and the engine accepts the
    # longest agreeing prefix (rewinding only the rejected suffix).
    # spec_k=1 is exactly the classic per-token speculative path.
    spec_k: int = 1
    # Paper-faithful: the content manager RELEASES hidden states of tokens
    # that exited early, so the cloud KV cache has gaps at those positions
    # (this is why Table 2 ROUGE-L < 1 for theta < 1).  backfill=True is the
    # beyond-paper fix: ringed uploads are run through the cloud partition on
    # the next request, keeping cloud KV exact at modest extra cloud compute.
    backfill: bool = False
    # KV layout of the batched serving engine: "dense" pins each slot to a
    # max_seq ring (memory B x max_seq); "paged" shares a block-paged pool
    # across slots (memory num_pages x page_size; see docs/kv_paging.md).
    # Release-mode gaps survive either way: a gapped position is simply a
    # page slot whose pos marker was never written.
    kv_layout: str = "dense"
    page_size: int = 16               # tokens per KV page (paged layout)
    # Storage dtype of the paged KV pool.  "int8" quantizes K/V per
    # page-row on write (one absmax scale per (token, kv_head) row, the
    # transport quantizer's scaling) and dequantizes at gather — in-kernel
    # for the Pallas paged flash-decode, so int8 pages cut decode HBM
    # traffic instead of being expanded in XLA first.  Swap snapshots and
    # admission scatters carry the quantized pages + scales verbatim, so
    # preemption swap bytes shrink by the same factor.  float32 stays
    # bit-identical to the dense layout; int8 trades bounded quantization
    # error (see docs/kv_paging.md §Quantized pages) for ~3.4x less KV
    # traffic.  Only meaningful with kv_layout="paged".
    kv_dtype: str = "float32"         # "float32" | "int8"
    # Paged-KV preemption (docs/kv_paging.md §Preemption).  "off" keeps the
    # conservative worst-case admission check (a stream admitted under
    # backpressure can always finish, but the pool is sized for worst
    # cases that rarely materialize).  Otherwise admission is optimistic —
    # only the prompt's pages need to fit — and a decode-time OutOfPages
    # preempts a victim stream: its stream state is checkpointed, its
    # pages freed, and it resumes later by "recompute" (re-prefill the KV
    # from its token prefix) or "swap" (pages round-trip through a
    # host-side SwapPool).  Preemption is invisible in output space:
    # greedy token streams are identical to an un-preempted run.
    preemption: str = "off"           # "off" | "recompute" | "swap"
    preempt_policy: str = "youngest"  # "youngest" | "fewest-pages" | "lru"
    # Chunked prefill admission (docs/serving.md): instead of one
    # monolithic padded prefill at admission, the prompt is prefilled in
    # page-sized chunks interleaved with decode ticks (a per-slot
    # ``prefill_remaining`` state machine), so a long prompt stops
    # monopolizing an engine tick.  Requires kv_layout="paged" and an
    # attention-only decoder-only model (the chunk step rides the paged
    # decode write path).  Chunked runs are token-identical to each other
    # but may differ from the monolithic path in float ulps (different
    # reduction order) — comparisons should hold the admission mode fixed.
    chunked_prefill: bool = False
    # Radix prefix sharing + copy-on-write (docs/kv_paging.md §Prefix
    # sharing): the PagePool keeps a trie of page-aligned prompt token
    # chunks so streams whose prompts share a prefix map the SAME physical
    # pages (refcounted); the first divergent write to a shared page
    # triggers a copy-on-write split.  Identical whole prompts additionally
    # cache their greedy first token, skipping prefill entirely.  Requires
    # chunked_prefill=True (suffix-only compute) and greedy sampling.
    prefix_share: bool = False
    # Cloud execution mesh (docs/sharding.md): a (data, model) device grid,
    # e.g. (2, 4), the cloud partition's jitted steps compile against —
    # params placed via role-based NamedShardings, the pooled batch-major
    # cloud KV via cache_shardings, residual/logits constraints baked into
    # the cloud traces.  None (the default) keeps the single-device path:
    # no mesh, no policy, plain jax.jit.  Needs prod(cloud_mesh) visible
    # devices (locally: XLA_FLAGS=--xla_force_host_platform_device_count=N).
    cloud_mesh: Optional[Tuple[int, int]] = None


class EdgeStepOut(NamedTuple):
    decisions: Dict[int, ExitDecision]
    token: torch.Tensor            # (B,) first-confident-exit token
    exited: torch.Tensor           # (B,) bool
    upload: Dict[str, torch.Tensor]   # quantized l_ee1 hidden (wire packet)
    caches: Caches


class CoLLM:
    """Binds a Model to the paper's partition + gating machinery."""

    def __init__(self, model: Model, ccfg: CollmConfig = CollmConfig()):
        cfg = model.cfg
        if len(cfg.exit_layers) < 1:
            raise ValueError("CE-CoLLM requires at least one exit layer")
        if ccfg.wire_format not in FORMATS:
            raise ValueError(f"wire_format must be one of {FORMATS}, got "
                             f"{ccfg.wire_format!r}")
        ported = CollmConfig(theta=ccfg.theta, wire_format=ccfg.wire_format,
                             backfill=ccfg.backfill)
        if ccfg != ported:
            changed = [f.name for f in dataclasses.fields(ccfg)
                       if getattr(ccfg, f.name) != getattr(ported, f.name)]
            raise NotImplementedError(
                f"CollmConfig fields {changed} select batched-engine "
                f"features that are not ported yet (ROADMAP A.5)")
        self.model = model
        self.ccfg = ccfg
        self.l_ee1 = cfg.exit_layers[0]
        self.l_ee2 = cfg.exit_layers[-1]
        self.edge_segs = model.edge_segments(self.l_ee2)
        self.cloud_segs = model.cloud_segments(self.l_ee1)

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------
    def init_edge_cache(self, batch: int, max_seq: int) -> Caches:
        return self.model.init_cache(batch, max_seq, self.edge_segs)

    def init_cloud_cache(self, batch: int, max_seq: int) -> Caches:
        return self.model.init_cache(batch, max_seq, self.cloud_segs)

    # ------------------------------------------------------------------
    # exits
    # ------------------------------------------------------------------
    def exit_decision(self, layer: int, hidden: torch.Tensor) -> ExitDecision:
        """The exit head at ``layer`` on a (B, d) or (B, 1, d) hidden."""
        m = self.model
        return evaluate_exit(hidden, m.unembed_weight(),
                             m.exit_norms[str(layer)], m.cfg.norm_eps)

    # ------------------------------------------------------------------
    # prefill (prompt processing)
    # ------------------------------------------------------------------
    def edge_prefill(self, batch: Dict[str, torch.Tensor], caches: Caches):
        """Edge processes the prompt; returns (exit decisions at the last
        position, l_ee1 hidden sequence for upload, caches)."""
        _, exit_h, caches, _ = self.model.prefill(batch, caches,
                                                  self.edge_segs)
        decisions = {l: self.exit_decision(l, h[:, -1])
                     for l, h in exit_h.items()}
        return decisions, exit_h[self.l_ee1], caches

    def cloud_prefill(self, h1_seq: torch.Tensor, caches: Caches):
        """Cloud builds its KV over the uploaded prompt hidden states;
        returns (last-position logits (B,1,V), caches)."""
        ctx = BlockCtx(positions=torch.arange(h1_seq.shape[1],
                                              device=h1_seq.device))
        x, _, caches = self.model.run_segments(h1_seq, ctx, self.cloud_segs,
                                               caches=caches,
                                               collect_exits=False)
        return self.model.logits(x[:, -1:]), caches

    # ------------------------------------------------------------------
    # decode steps
    # ------------------------------------------------------------------
    def edge_step(self, token: torch.Tensor, caches: Caches,
                  pos) -> EdgeStepOut:
        _, exit_h, caches = self.model.decode_step(token, caches, pos,
                                                   self.edge_segs)
        decisions = {l: self.exit_decision(l, h) for l, h in exit_h.items()}
        tok, exited, _ = first_confident_exit(decisions, self.ccfg.theta)
        upload = quantize(exit_h[self.l_ee1], self.ccfg.wire_format)
        return EdgeStepOut(decisions, tok, exited, upload, caches)

    def fused_exit_upload(self, hidden: torch.Tensor):
        """The l_ee1 exit + int8 upload in ONE ``exit_quant`` launch over
        the hidden, in place of ``edge_step``'s exit_head + quantize pair.

        ``hidden``: (B, 1, d) or (B, d).  Returns (confidence (B,),
        token (B,), packet) where ``packet`` has exactly the layout of
        ``transport.quantize(hidden, "int8")``."""
        m = self.model
        shape = hidden.shape
        h2 = hidden.reshape(shape[0], shape[-1]).contiguous()
        conf, tok, _, q, s = exit_quant(h2, m.unembed_weight(),
                                        m.exit_norms[str(self.l_ee1)],
                                        eps=m.cfg.norm_eps)
        return conf, tok, {"data": q.reshape(shape),
                           "scale": s.reshape(*shape[:-1], 1)}

    def cloud_step(self, upload: Dict[str, torch.Tensor], caches: Caches,
                   pos) -> Tuple[torch.Tensor, Caches]:
        """One uploaded hidden -> final logits (B, V) (paper Algorithm 1
        lines 29-37).  Also used for KV backfill of early-exited
        positions."""
        hidden = dequantize(upload, self.model.dtype)
        x, _, caches = self.model.decode_from_hidden(hidden, caches, pos,
                                                     self.cloud_segs)
        return self.model.logits(x)[:, 0], caches

    def standalone_step(self, token: torch.Tensor, caches: Caches, pos):
        """Edge standalone (low-latency) mode: the last exit is the
        output."""
        _, exit_h, caches = self.model.decode_step(token, caches, pos,
                                                   self.edge_segs)
        d = self.exit_decision(self.l_ee2, exit_h[self.l_ee2])
        return d.token, d, caches

    def full_step(self, token: torch.Tensor, caches: Caches, pos):
        """Undivided model — the cloud-deployment baseline."""
        x, _, caches = self.model.decode_step(token, caches, pos,
                                              collect_exits=False)
        logits = self.model.logits(x)[:, 0]
        return logits.argmax(dim=-1).to(torch.int32), logits, caches
