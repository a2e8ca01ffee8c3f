"""Stack assembler: composes decoder blocks into a model with early-exit
heads and edge/cloud partitions (the paper's technique).

Port of ``repro.models.transformer``.  Layers live in one
``nn.ModuleList``; a *segment* is an index range over it — a maximal run of
identical (kind, window), additionally cut at every early-exit layer, so
the partition boundaries (``l_ee1``, ``l_ee2``) are always segment
boundaries and edge/cloud partitions are segment subsets.  Caches are
``{segment index: [per-layer cache, ...]}`` and are updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.configs.base import DENSE, SHARED_ATTN, ModelConfig
from repro_torch.models.blocks import (BlockCtx, DecoderBlock, block_decode,
                                       block_forward, init_block,
                                       init_block_cache,
                                       init_block_cache_paged)
from repro_torch.models.common import embed_init_, rms_norm

Caches = Dict[int, List[Dict[str, Any]]]


@dataclasses.dataclass(frozen=True)
class SegmentSpec:
    kind: str
    window: int
    start: int          # 0-based first layer index
    length: int
    shared: bool = False

    @property
    def end(self) -> int:          # exclusive
        return self.start + self.length


def build_segments(cfg: ModelConfig) -> Tuple[SegmentSpec, ...]:
    kinds = cfg.block_kinds()
    windows = cfg.layer_windows()
    cuts = set(cfg.exit_layers)                  # cut AFTER 1-based layer l
    segs: List[SegmentSpec] = []
    start = 0
    for i in range(1, cfg.n_layers + 1):
        boundary = (
            i == cfg.n_layers
            or kinds[i] != kinds[i - 1]
            or windows[i] != windows[i - 1]
            or i in cuts
            or kinds[i - 1] == SHARED_ATTN       # shared blocks stand alone
            or kinds[i] == SHARED_ATTN
        )
        if boundary:
            segs.append(SegmentSpec(kind=kinds[start], window=windows[start],
                                    start=start, length=i - start,
                                    shared=kinds[start] == SHARED_ATTN))
            start = i
    return tuple(segs)


class Model(nn.Module):
    """Dense early-exit decoder.  Parameter names follow the JAX package's
    pytree: ``embed``, ``layers.<i>.*``, ``final_norm``, ``lm_head``
    (untied only) and ``exit_norms.<layer>``."""

    def __init__(self, cfg: ModelConfig, *, device, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg.validate()
        if (any(k != DENSE for k in cfg.block_kinds()) or cfg.is_encdec
                or cfg.vision_tokens or not cfg.use_rope
                or cfg.norm_type != "rms"):
            raise NotImplementedError(
                f"{cfg.name}: only the dense rotary rms-norm decoder is "
                f"ported yet (ROADMAP A.9)")
        self.segments = build_segments(cfg)
        self.dtype = dtype
        kw = dict(device=device, dtype=dtype)
        d, v = cfg.d_model, cfg.vocab_size
        self.embed = nn.Parameter(torch.empty(v, d, **kw))
        self.layers = nn.ModuleList(DecoderBlock(cfg, device=device,
                                                 dtype=dtype)
                                    for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.empty(d, **kw))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(v, d, **kw))
        # per-exit read-out norms; the heads share the unembedding
        self.exit_norms = nn.ParameterDict(
            {str(l): nn.Parameter(torch.empty(d, **kw))
             for l in cfg.exit_layers})

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "Model":
        """Fill every parameter from ``gen`` with the JAX package's
        distributions (random weights: the repository has no trained 7B
        checkpoint)."""
        cfg = self.cfg
        embed_init_(self.embed, gen)
        for block in self.layers:
            init_block(block, cfg, gen)
        self.final_norm.zero_()       # rms gains are (1 + scale)
        if not cfg.tie_embeddings:
            embed_init_(self.lm_head, gen)
        for w in self.exit_norms.values():
            w.zero_()
        return self

    # ------------------------------------------------------------------
    # norms / heads
    # ------------------------------------------------------------------
    def unembed_weight(self) -> torch.Tensor:
        """(V, d) read-out weight (tied or separate)."""
        return self.embed if self.cfg.tie_embeddings else self.lm_head

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        w = self.unembed_weight()
        h = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return h @ w.to(x.dtype).T

    def exit_logits(self, layer: int, x: torch.Tensor) -> torch.Tensor:
        """Full exit-head logits (the serving path takes the ``exit_head``
        kernel instead, which never writes them)."""
        h = rms_norm(x, self.exit_norms[str(layer)], self.cfg.norm_eps)
        return h @ self.unembed_weight().to(x.dtype).T

    # ------------------------------------------------------------------
    # embedding front-end
    # ------------------------------------------------------------------
    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens].to(self.dtype)

    # ------------------------------------------------------------------
    # segment execution
    # ------------------------------------------------------------------
    def run_segments(self, x: torch.Tensor, ctx: BlockCtx,
                     seg_indices: Sequence[int],
                     caches: Optional[Caches] = None,
                     collect_exits: bool = True):
        """Full-sequence execution of the given segments.

        Returns (x, exit_hiddens {1-based layer: hidden}, caches)."""
        cfg = self.cfg
        exit_set = set(cfg.exit_layers) if collect_exits else set()
        exit_hiddens: Dict[int, torch.Tensor] = {}
        for si in seg_indices:
            seg = self.segments[si]
            sctx = dataclasses.replace(ctx, window=seg.window)
            for j in range(seg.length):
                cache = caches[si][j] if caches is not None else None
                x, _ = block_forward(self.layers[seg.start + j], cfg, x,
                                     sctx, cache=cache)
            if seg.end in exit_set:
                exit_hiddens[seg.end] = x
        return x, exit_hiddens, caches

    def decode_segments(self, x: torch.Tensor, ctx: BlockCtx,
                        seg_indices: Sequence[int], caches: Caches,
                        collect_exits: bool = True):
        """Single-token execution.  Returns (x, exit_hiddens, caches)."""
        cfg = self.cfg
        exit_set = set(cfg.exit_layers) if collect_exits else set()
        exit_hiddens: Dict[int, torch.Tensor] = {}
        for si in seg_indices:
            seg = self.segments[si]
            sctx = dataclasses.replace(ctx, window=seg.window)
            for j in range(seg.length):
                x, _ = block_decode(self.layers[seg.start + j], cfg, x,
                                    caches[si][j], sctx)
            if seg.end in exit_set:
                exit_hiddens[seg.end] = x
        return x, exit_hiddens, caches

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int,
                   seg_indices: Optional[Sequence[int]] = None) -> Caches:
        seg_indices = (range(len(self.segments)) if seg_indices is None
                       else seg_indices)
        return {si: [init_block_cache(self.cfg, batch, max_seq,
                                      self.segments[si].window,
                                      device=self.device, dtype=self.dtype)
                     for _ in range(self.segments[si].length)]
                for si in seg_indices}

    def init_paged_cache(self, num_pages: int, page_size: int,
                         seg_indices: Optional[Sequence[int]] = None,
                         kv_dtype: str = "float32") -> Caches:
        """Block-paged caches: self-attention K/V is pooled across rows in
        ``num_pages`` pages of ``page_size`` tokens (plus a trash page) and
        addressed through a per-row block table passed to ``decode_step``
        (the pool has no batch axis).  ``kv_dtype="int8"`` stores pages
        quantized with per-row scales; otherwise in the model's dtype."""
        seg_indices = (range(len(self.segments)) if seg_indices is None
                       else seg_indices)
        return {si: [init_block_cache_paged(self.cfg, num_pages, page_size,
                                            device=self.device,
                                            dtype=self.dtype,
                                            kv_dtype=kv_dtype)
                     for _ in range(self.segments[si].length)]
                for si in seg_indices}

    def invalidate_cache_after(self, caches: Caches, true_len: int) -> Caches:
        """Mark self-attention ring slots >= true_len invalid (pos = -1),
        in place — used after a right-padded prefill so pad positions never
        take part in decode attention."""
        for layers in caches.values():
            for c in layers:
                c["self"]["pos"][:, true_len:] = -1
        return caches

    # ------------------------------------------------------------------
    # public entry points
    # ------------------------------------------------------------------
    def all_segments(self) -> Tuple[int, ...]:
        return tuple(range(len(self.segments)))

    def edge_segments(self, l_ee2: Optional[int] = None) -> Tuple[int, ...]:
        l_ee2 = l_ee2 or (self.cfg.exit_layers[-1] if self.cfg.exit_layers
                          else self.cfg.n_layers)
        return tuple(i for i, s in enumerate(self.segments) if s.end <= l_ee2)

    def cloud_segments(self, l_ee1: Optional[int] = None) -> Tuple[int, ...]:
        """Segments from l_ee1 on: the cloud continues from the l_ee1
        upload, so it recomputes layers l_ee1+1..l_ee2 itself."""
        l_ee1 = l_ee1 or (self.cfg.exit_layers[0] if self.cfg.exit_layers
                          else 0)
        return tuple(i for i, s in enumerate(self.segments)
                     if s.start >= l_ee1)

    def prefill(self, batch: Dict[str, torch.Tensor], caches: Caches,
                seg_indices: Optional[Sequence[int]] = None):
        """Full-sequence pass that fills caches.  batch["tokens"]: (B, S)
        int64.  Returns (hidden (B,S,d), exit_hiddens, caches, ctx)."""
        seg_indices = seg_indices or self.all_segments()
        tokens = batch["tokens"]
        x = self.embed_tokens(tokens)
        ctx = BlockCtx(positions=torch.arange(tokens.shape[1],
                                              device=self.device))
        x, exit_hiddens, caches = self.run_segments(x, ctx, seg_indices,
                                                    caches=caches)
        return x, exit_hiddens, caches, ctx

    def _rows_pos(self, pos, b: int) -> torch.Tensor:
        """A scalar or per-row position as a (B,) int32 device tensor."""
        return torch.as_tensor(pos, dtype=torch.int32, device=self.device
                               ).broadcast_to((b,)).contiguous()

    def decode_step(self, token: torch.Tensor, caches: Caches, pos,
                    seg_indices: Optional[Sequence[int]] = None,
                    collect_exits: bool = True,
                    block_tbl: Optional[torch.Tensor] = None,
                    write_mask: Optional[torch.Tensor] = None):
        """token: (B,1); pos: scalar or per-row (B,) position ->
        (final hidden (B,1,d), exit_hiddens, caches).  Paged caches need
        ``block_tbl`` (B, max_logical) int32 on the model's device;
        ``write_mask`` (B,) bool leaves the masked-out rows' KV as it
        was."""
        seg_indices = seg_indices or self.all_segments()
        x = self.embed_tokens(token)
        ctx = BlockCtx(pos=self._rows_pos(pos, token.shape[0]),
                       block_tbl=block_tbl, write_mask=write_mask)
        return self.decode_segments(x, ctx, seg_indices, caches,
                                    collect_exits=collect_exits)

    def decode_from_hidden(self, hidden: torch.Tensor, caches: Caches, pos,
                           seg_indices: Sequence[int],
                           block_tbl: Optional[torch.Tensor] = None,
                           write_mask: Optional[torch.Tensor] = None):
        """Cloud-partition decode: continue from an uploaded hidden state."""
        ctx = BlockCtx(pos=self._rows_pos(pos, hidden.shape[0]),
                       block_tbl=block_tbl, write_mask=write_mask)
        return self.decode_segments(hidden, ctx, seg_indices, caches,
                                    collect_exits=False)
