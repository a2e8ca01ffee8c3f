"""CE-CoLLM co-inference steps (paper §4.4, Algorithm 1).

Port of ``repro.core.collm`` for the sequential loop and the batched
engine, on dense ring KV or a block-paged pool (float or int8 pages):

  * ``edge_step``        — edge partition (layers 1..l_ee2) with exits at
                           l_ee1/l_ee2; emits the quantized l_ee1 upload.
  * ``fused_exit_upload``— the l_ee1 exit decision and its int8 upload in
                           one ``exit_quant`` kernel launch.
  * ``cloud_step``       — cloud partition (layers l_ee1+1..L) continuing
                           from an uploaded hidden state; also backfills
                           the KV of early-exited tokens.
  * ``standalone_step``  — the paper's low-latency edge standalone mode.
  * ``full_step``        — undivided model (cloud-deployment baseline).
  * ``*_prefill_padded`` — right-padded prompt prefill of one admission.
  * ``cloud_step(write_mask=)``/``ring_cloud_steps``/
    ``ring_cloud_steps_all`` — the batched engines' cloud call over the
                           below-θ rows (and their backfill rings or
                           k-token drafts); the other rows' caches stay as
                           they were.
  * ``edge_step_masked`` — an edge step whose masked-out rows keep their
                           caches.
  * ``invalidate_rows_after`` — per-row KV rollback (speculative rewind).
  * ``fused_step``       — the single-graph adaptive step with per-row
                           upload rings (``fused_edge_phase`` +
                           ``fused_cloud_phase``); only tests call it.

Exit decisions go through the ``exit_head`` kernel and the int8 wire format
through the ``quantize`` kernel; a sampler other than greedy asks for the
exit logits too (``with_logits=True``), which the kernel never writes.  KV
caches are updated in place, so a masked step never writes a masked-out row
(the JAX package computes every row and merges the old ones back).
``CoLLM`` raises for any ``CollmConfig`` field that selects a feature not
ported yet, naming its ROADMAP queue item (``UNPORTED_FIELDS``).
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


# CollmConfig fields the port refuses, with the ROADMAP queue-A item that
# ports each: chunked prefill and prefix sharing (A.5), the cloud mesh
# (A.11)
UNPORTED_FIELDS = {"chunked_prefill": "A.5", "prefix_share": "A.5",
                   "cloud_mesh": "A.11"}


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
        if ccfg.kv_dtype not in ("float32", "int8"):
            raise ValueError(f"kv_dtype must be 'float32' or 'int8', "
                             f"got {ccfg.kv_dtype!r}")
        if ccfg.kv_dtype == "int8" and ccfg.kv_layout != "paged":
            raise ValueError('kv_dtype="int8" requires kv_layout="paged" '
                             "(dense rings stay full precision)")
        if ccfg.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {ccfg.spec_k}")
        if ccfg.spec_k > 1 and not ccfg.speculative:
            raise ValueError("spec_k > 1 requires speculative=True "
                             "(drafting generalizes the speculative path)")
        default = CollmConfig()
        changed = {name: item for name, item in UNPORTED_FIELDS.items()
                   if getattr(ccfg, name) != getattr(default, name)}
        if changed:
            raise NotImplementedError(
                f"CollmConfig fields {sorted(changed)} select features that "
                f"are not ported yet ("
                + ", ".join(f"{n}: ROADMAP {i}"
                            for n, i in sorted(changed.items())) + ")")
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

    def init_edge_cache_paged(self, batch: int, num_pages: int,
                              page_size: int) -> Caches:
        """Paged edge caches; ``batch`` rows address them through the block
        table (attention-only partitions keep no per-row state)."""
        del batch
        return self.model.init_paged_cache(num_pages, page_size,
                                           self.edge_segs,
                                           kv_dtype=self.ccfg.kv_dtype)

    def init_cloud_cache_paged(self, batch: int, num_pages: int,
                               page_size: int) -> Caches:
        del batch
        return self.model.init_paged_cache(num_pages, page_size,
                                           self.cloud_segs,
                                           kv_dtype=self.ccfg.kv_dtype)

    # ------------------------------------------------------------------
    # exits
    # ------------------------------------------------------------------
    def exit_decision(self, layer: int, hidden: torch.Tensor,
                      with_logits: bool = False) -> ExitDecision:
        """The exit head at ``layer`` on a (B, d) or (B, 1, d) hidden.  The
        decision comes from the ``exit_head`` kernel; ``with_logits`` adds
        the (B, V) exit logits a sampler draws from (plain PyTorch)."""
        m = self.model
        d = evaluate_exit(hidden, m.unembed_weight(),
                          m.exit_norms[str(layer)], m.cfg.norm_eps)
        if with_logits:
            h2 = hidden.reshape(hidden.shape[0], hidden.shape[-1])
            d = d._replace(logits=m.exit_logits(layer, h2))
        return d

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
    # right-padded prefill (one admission of the batch scheduler)
    # ------------------------------------------------------------------
    def edge_prefill_padded(self, tokens: torch.Tensor, true_len: int,
                            caches: Caches, with_logits: bool = False):
        """Edge prefill over a right-padded prompt (tokens: (1, Lb)).

        Pad positions are causally invisible to real tokens, so the real
        activations equal an unpadded prefill's; pad cache slots are
        invalidated afterwards.  Exit decisions are evaluated at the TRUE
        last position.  Returns (decisions, l_ee1 hidden sequence,
        caches)."""
        _, exit_h, caches, _ = self.model.prefill({"tokens": tokens}, caches,
                                                  self.edge_segs)
        decisions = {l: self.exit_decision(l, h[:, true_len - 1],
                                           with_logits)
                     for l, h in exit_h.items()}
        caches = self.model.invalidate_cache_after(caches, true_len)
        return decisions, exit_h[self.l_ee1], caches

    def cloud_prefill_padded(self, h1_seq: torch.Tensor, true_len: int,
                             caches: Caches):
        """Cloud prefill over a right-padded prompt upload; logits (1,1,V)
        at the true last position, pad cache slots invalidated."""
        ctx = BlockCtx(positions=torch.arange(h1_seq.shape[1],
                                              device=h1_seq.device))
        x, _, caches = self.model.run_segments(h1_seq, ctx, self.cloud_segs,
                                               caches=caches,
                                               collect_exits=False)
        logits = self.model.logits(x[:, true_len - 1:true_len])
        return logits, self.model.invalidate_cache_after(caches, true_len)

    def full_prefill_padded(self, tokens: torch.Tensor, true_len: int,
                            caches: Caches):
        """Undivided-model prefill over a right-padded prompt (cloud
        baseline rows of the batch scheduler)."""
        x, _, caches, _ = self.model.prefill({"tokens": tokens}, caches)
        logits = self.model.logits(x[:, true_len - 1:true_len])
        return logits, self.model.invalidate_cache_after(caches, true_len)

    # ------------------------------------------------------------------
    # decode steps
    # ------------------------------------------------------------------
    def edge_step(self, token: torch.Tensor, caches: Caches, pos,
                  block_tbl: Optional[torch.Tensor] = None,
                  with_logits: bool = False) -> EdgeStepOut:
        _, exit_h, caches = self.model.decode_step(token, caches, pos,
                                                   self.edge_segs,
                                                   block_tbl=block_tbl)
        decisions = {l: self.exit_decision(l, h, with_logits)
                     for l, h in exit_h.items()}
        tok, exited, _ = first_confident_exit(decisions, self.ccfg.theta)
        upload = quantize(exit_h[self.l_ee1], self.ccfg.wire_format)
        return EdgeStepOut(decisions, tok, exited, upload, caches)

    def edge_step_masked(self, token: torch.Tensor, caches: Caches, pos,
                         run_mask: torch.Tensor,
                         block_tbl: Optional[torch.Tensor] = None
                         ) -> EdgeStepOut:
        """Batched edge step that leaves masked-out rows' caches bit for
        bit: ``run_mask`` (B,) bool is the KV write mask (dense rows write
        their old entry back, paged rows write to the trash page), so no
        merge of old and new caches is needed.  The outputs of masked-out
        rows are meaningless."""
        _, exit_h, caches = self.model.decode_step(token, caches, pos,
                                                   self.edge_segs,
                                                   block_tbl=block_tbl,
                                                   write_mask=run_mask)
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
                   pos, block_tbl: Optional[torch.Tensor] = None,
                   write_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Caches]:
        """One uploaded hidden -> final logits (B, V) (paper Algorithm 1
        lines 29-37).  Also used for KV backfill of early-exited
        positions.  With ``write_mask`` it is the batched engine's cloud
        call (the JAX package's ``cloud_step_masked``): rows with
        mask=False keep their caches bit for bit, because the mask is the
        KV write mask (dense rows write their old entry back, paged rows
        write to the trash page), so no merge of old and new caches is
        needed (JAX's ``_caches_where_rows``)."""
        hidden = dequantize(upload, self.model.dtype)
        x, _, caches = self.model.decode_from_hidden(
            hidden, caches, pos, self.cloud_segs, block_tbl=block_tbl,
            write_mask=write_mask)
        return self.model.logits(x)[:, 0], caches

    def invalidate_rows_after(self, caches: Caches, cut: torch.Tensor,
                              block_tbl: Optional[torch.Tensor] = None
                              ) -> Caches:
        """Per-row KV rollback, in place: mark each row's self-attention
        entries at positions >= ``cut[row]`` invalid (pos = -1).  Dense
        rings match on the stored pos marker; paged nodes scatter a
        per-page threshold through the block table.  Rows that are not
        being rewound pass ``cut = INT32_MAX``."""
        cut = torch.as_tensor(cut, dtype=torch.int32,
                              device=self.model.device)
        for layers in caches.values():
            for c in layers:
                node = c["self"]
                if "kp" not in node:
                    p = node["pos"]
                    p.masked_fill_(p >= cut[:, None], -1)
                    continue
                p = node["pos"]
                thr = torch.full((p.shape[0],), torch.iinfo(torch.int32).max,
                                 dtype=torch.int32, device=p.device)
                # the trash page (id 0) may collect several rows'
                # thresholds; its markers are always -1, never >= a cut
                dest = torch.where(block_tbl >= 0, block_tbl, 0).reshape(-1)
                thr[dest.long()] = cut.repeat_interleave(block_tbl.shape[1])
                p.masked_fill_(p >= thr[:, None], -1)
        return caches

    def ring_cloud_steps(self, ring: Dict[str, torch.Tensor],
                         ring_pos: torch.Tensor, ring_valid: torch.Tensor,
                         caches: Caches,
                         block_tbl: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, Caches]:
        """Drain a per-row upload ring through the cloud partition in order
        (backfill).  ring: packet dict of stacked leaves with a leading
        ring axis, e.g. {"data": (k, B, 1, d)}; ring_pos: (k, B) per-entry
        positions; ring_valid: (k, B) bool — invalid entries leave the
        row's cache and logits untouched.  Returns (per-row logits of each
        row's LAST valid entry (B, V) float32, caches).  The JAX package's
        ``lax.scan`` is a loop here."""
        final, _, caches = self._ring_pass(ring, ring_pos, ring_valid, caches,
                                           block_tbl, keep_all=False)
        return final, caches

    def ring_cloud_steps_all(self, ring: Dict[str, torch.Tensor],
                             ring_pos: torch.Tensor, ring_valid: torch.Tensor,
                             caches: Caches,
                             block_tbl: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, Caches]:
        """``ring_cloud_steps`` that also returns EVERY entry's logits:
        (last-valid logits (B, V) f32, per-entry logits (k, B, V) f32 with
        invalid entries zeroed, caches).  The ``CloudBatcher``'s ring waves
        take this form."""
        return self._ring_pass(ring, ring_pos, ring_valid, caches, block_tbl,
                               keep_all=True)

    def _ring_pass(self, ring, ring_pos, ring_valid, caches, block_tbl,
                   keep_all: bool):
        final = torch.zeros((ring_pos.shape[1], self.model.cfg.vocab_size),
                            dtype=torch.float32, device=ring_pos.device)
        steps = []
        for i in range(ring_pos.shape[0]):
            # a copy of the row: the kernels take 16-byte aligned positions
            logits, caches = self.cloud_step(
                {k: v[i] for k, v in ring.items()}, caches,
                ring_pos[i].clone(), block_tbl=block_tbl,
                write_mask=ring_valid[i])
            valid = ring_valid[i][:, None]
            final = torch.where(valid, logits.float(), final)
            if keep_all:
                steps.append(torch.where(valid, logits.float(), 0.0))
        return final, (torch.stack(steps) if keep_all else None), caches

    def standalone_step(self, token: torch.Tensor, caches: Caches, pos):
        """Edge standalone (low-latency) mode: the last exit is the
        output."""
        _, exit_h, caches = self.model.decode_step(token, caches, pos,
                                                   self.edge_segs)
        d = self.exit_decision(self.l_ee2, exit_h[self.l_ee2])
        return d.token, d, caches

    def full_step(self, token: torch.Tensor, caches: Caches, pos,
                  block_tbl: Optional[torch.Tensor] = None):
        """Undivided model — the cloud-deployment baseline."""
        x, _, caches = self.model.decode_step(token, caches, pos,
                                              collect_exits=False,
                                              block_tbl=block_tbl)
        logits = self.model.logits(x)[:, 0]
        return logits.argmax(dim=-1).to(torch.int32), logits, caches

    # ------------------------------------------------------------------
    # fused adaptive step (per-row upload rings, cloud gated on need)
    # ------------------------------------------------------------------
    def init_fused_state(self, batch: int, max_seq: int) -> dict:
        """Caches and per-row upload rings of ``fused_step``: ``ring_h``
        (max_pending, B, 1, d) hidden states, ``ring_pos`` (max_pending, B)
        positions and ``count`` (B,) entries held.  Paged layout: every row
        gets a fixed identity-mapped run of pages covering ``max_seq``
        (the step consults no host allocator)."""
        m = self.model
        k = self.ccfg.max_pending
        dev = m.device
        state = {
            "ring_h": torch.zeros((k, batch, 1, m.cfg.d_model),
                                  dtype=m.dtype, device=dev),
            "ring_pos": torch.zeros((k, batch), dtype=torch.int32,
                                    device=dev),
            "count": torch.zeros((batch,), dtype=torch.int32, device=dev),
        }
        if self.ccfg.kv_layout == "paged":
            ps = self.ccfg.page_size
            n_lp = -(-max_seq // ps)
            state["block_tbl"] = (1 + torch.arange(
                batch * n_lp, dtype=torch.int32, device=dev)
                                  ).reshape(batch, n_lp)
            state["edge"] = self.init_edge_cache_paged(batch, batch * n_lp,
                                                       ps)
            state["cloud"] = self.init_cloud_cache_paged(batch, batch * n_lp,
                                                         ps)
        else:
            state["edge"] = self.init_edge_cache(batch, max_seq)
            state["cloud"] = self.init_cloud_cache(batch, max_seq)
        return state

    def fused_edge_phase(self, token: torch.Tensor, state: dict, pos):
        """Edge half of the fused step: decode, exit gating, and the ring
        push (in place) — no cloud compute.  Returns ``(out, rings,
        need_rows)`` where ``rings`` is {ring_h, ring_pos, count}."""
        ccfg = self.ccfg
        b = token.shape[0]
        k = ccfg.max_pending if ccfg.backfill else 1
        pos_b = torch.as_tensor(pos, dtype=torch.int32, device=token.device
                                ).broadcast_to((b,)).contiguous()
        out = self.edge_step(token, state["edge"], pos_b,
                             state.get("block_tbl"))
        # the wire: quantize -> dequantize
        h1 = dequantize(out.upload, self.model.dtype)
        # paper-faithful (no backfill): only the newest upload is kept —
        # the content manager releases the rest (gapped cloud KV)
        idx = (state["count"].long() if ccfg.backfill
               else torch.zeros((b,), dtype=torch.long, device=token.device))
        bidx = torch.arange(b, device=token.device)
        ring_h = state["ring_h"].index_put_(
            (idx, bidx), h1.to(state["ring_h"].dtype))
        ring_pos = state["ring_pos"].index_put_((idx, bidx), pos_b)
        count = (idx + 1).to(torch.int32)

        need_rows = ~out.exited
        if ccfg.backfill:
            need_rows = need_rows | (count >= k)     # ring full -> flush
        if ccfg.speculative:
            need_rows = torch.ones((b,), dtype=torch.bool,
                                   device=token.device)
        rings = {"ring_h": ring_h, "ring_pos": ring_pos, "count": count}
        return out, rings, need_rows

    def fused_cloud_phase(self, cloud_caches: Caches, rings: dict,
                          need_rows: torch.Tensor,
                          block_tbl: Optional[torch.Tensor] = None):
        """Cloud half of the fused step: drain the needy rows' upload rings
        in order.  ``need_rows.any()`` decides on the host whether the
        cloud runs at all (one device->host read a step; JAX's
        ``lax.cond``).  Returns (cloud_caches, cloud_logits (B, V) f32,
        new_count)."""
        k = self.ccfg.max_pending if self.ccfg.backfill else 1
        cnt = rings["count"]
        if not bool(need_rows.any()):
            logits = torch.zeros((need_rows.shape[0],
                                  self.model.cfg.vocab_size),
                                 dtype=torch.float32,
                                 device=need_rows.device)
            return cloud_caches, logits, cnt
        valid = ((torch.arange(k, device=cnt.device)[:, None] < cnt[None, :])
                 & need_rows[None])
        logits, cloud_caches = self.ring_cloud_steps(
            {"data": rings["ring_h"][:k]}, rings["ring_pos"][:k], valid,
            cloud_caches, block_tbl=block_tbl)
        return cloud_caches, logits, torch.where(need_rows, 0, cnt)

    def fused_step(self, token: torch.Tensor, state: dict, pos):
        """token: (B,1); pos: scalar or per-row (B,) position.  Returns
        (next_token (B,) int32, info, new_state); the caches and rings of
        ``state`` are updated in place.

        Every step each row pushes its l_ee1 hidden into its own upload
        ring.  Cloud compute runs only when some row is below θ or its ring
        is full (every row with ``speculative``); it then drains the rings
        of exactly the needy rows in order — backfilling their cloud KV —
        while confident rows' rings keep accumulating.  Without backfill
        each ring holds only the newest upload (release semantics: the
        cloud KV keeps gaps at early-exited positions)."""
        tbl = state.get("block_tbl")
        out, rings, need_rows = self.fused_edge_phase(token, state, pos)
        cloud_caches, cloud_logits, new_count = self.fused_cloud_phase(
            state["cloud"], rings, need_rows, block_tbl=tbl)
        cloud_tok = cloud_logits.argmax(dim=-1).to(torch.int32)
        next_token = torch.where(out.exited, out.token, cloud_tok)
        new_state = {"edge": out.caches, "cloud": cloud_caches,
                     "ring_h": rings["ring_h"], "ring_pos": rings["ring_pos"],
                     "count": new_count}
        if tbl is not None:
            new_state["block_tbl"] = tbl
        info = {"exited": out.exited, "need_cloud": need_rows.any(),
                "need_rows": need_rows, "cloud_logits": cloud_logits,
                "confidences": {l: d.confidence
                                for l, d in out.decisions.items()}}
        return next_token, info, new_state
