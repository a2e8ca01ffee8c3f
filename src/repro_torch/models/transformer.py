"""Stack assembler: composes decoder blocks into a model with early-exit
heads and edge/cloud partitions (the paper's technique).

Port of ``repro.models.transformer``.  Layers live in one
``nn.ModuleList``; a *segment* is an index range over it — a maximal run of
identical (kind, window), additionally cut at every early-exit layer, so
the partition boundaries (``l_ee1``, ``l_ee2``) are always segment
boundaries and edge/cloud partitions are segment subsets.  Caches are
``{segment index: [per-layer cache, ...]}`` and are updated in place.

Zamba2's shared attention block is one module, ``shared``, that every
shared segment (a length-1 segment of kind ``shared_attn``) runs, each
application with its own KV cache; its places in ``layers`` hold an
``nn.Identity`` so that every parameter has one name.

An encoder-decoder model (whisper) adds a non-causal ``encoder`` over
precomputed frames (``encode``) whose output every decoder block attends
to (cross-attention), with sinusoidal absolute positions and layer
norms; a vision-prefix model (paligemma) projects precomputed patches
through ``vis_proj`` in front of the tokens, which attend to that prefix
in both directions (the prefix-LM mask).  ``embed_inputs`` is the
front-end of both; the serving engines take token prompts only, as the
JAX package's do.

Training runs ``forward_train`` (every head's logits) or
``forward_train_hiddens`` (the hidden states the fused loss of
``repro_torch.training.loss`` unembeds chunk by chunk): the whole stack
with every block under activation checkpointing, and the MoE blocks'
load-balance losses summed into ``aux_loss``.

Under a model ``axis`` (a rank of the cloud mesh, ``launch/mesh.py``) the
model is that rank's share of the single-device model, split by the JAX
package's rules (``launch/sharding.py``): the embedding (and ``lm_head``)
over the vocabulary, the attention heads (self, cross, the shared block's
and the encoder's), the FFN's d_ff, the experts' d_ff, the recurrent
blocks' heads and ``vis_proj``'s columns; norms and routers whole.  Where
the port's share departs from the rules (the packed projections of the
recurrent blocks) ``launch/sharding.py`` lists it.  ``embed_tokens`` goes
through ``embed_lookup``, ``logits`` / ``exit_logits`` through
``gather_vocab``, the blocks sum their row-parallel products
(``reduce_model``), the patches' projection is gathered
(``gather_heads``), and the caches keep the rank's KV heads and
recurrent heads; activations stay whole between blocks.  ``init`` draws
each parameter whole from the generator, one at a time, and keeps the
rank's share, so a rank holds exactly its share of the single-device
model and never the whole model.

A ``tier`` model is one partition of the two-tier deployment
(``core/disagg.py``), holding only what that tier runs: the ``"edge"``
tier the embedding (and the encoder or ``vis_proj``), layers 1..l_ee2,
the exit norms and the unembedding the exit heads read; the ``"cloud"``
tier layers l_ee1+1..L, the final norm and the same unembedding (the
embedding when tied, ``lm_head`` when not).  Its parameters keep the
whole model's names; the place of a layer the other tier holds is an
``OtherTier``, which holds nothing and raises when it is used, so a call
into the other partition fails instead of running something else.  Its
weights come from the whole model (``load_whole``) or from the JAX
parameters (``bridge.params_from_jax(tier=)``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import DENSE, SHARED_ATTN, ModelConfig
from repro_torch.launch.sharding import (Axis, embed_lookup, gather_heads,
                                         gather_vocab)
from repro_torch.models import cache_tree
from repro_torch.models.attention import head_split
from repro_torch.models.blocks import (ATTN_KINDS, BlockCtx, DecoderBlock,
                                       block_decode, block_forward,
                                       init_block, init_block_cache,
                                       init_block_cache_paged, make_block)
from repro_torch.models.common import (dense_init_, embed_init_,
                                       layer_norm, rms_norm,
                                       sinusoidal_positions)
from repro_torch.tracing import span

Caches = Dict[int, List[Dict[str, Any]]]
TIERS = ("edge", "cloud")


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


class OtherTierError(AttributeError):
    """A tier model was asked for a part that the other tier holds."""


class OtherTier(nn.Module):
    """The place of layer ``layer`` (0-based) in a tier model that does
    not hold it: no parameters, and any attribute it lacks raises
    ``OtherTierError`` naming the tier that holds the layer."""

    def __init__(self, layer: int, holder: str):
        super().__init__()
        self.layer = layer
        self.holder = holder

    def __getattr__(self, name: str):
        raise OtherTierError(f"layer {self.layer + 1} is held by the "
                             f"{self.holder} tier ({name!r})")


def tier_layers(cfg: ModelConfig, tier: Optional[str]) -> range:
    """The 0-based layers a ``tier`` holds: the edge 1..l_ee2, the cloud
    l_ee1+1..L (1-based), the whole model (``tier=None``) all."""
    if tier is None:
        return range(cfg.n_layers)
    if tier not in TIERS:
        raise ValueError(f"tier must be one of {TIERS}, got {tier!r}")
    if not cfg.exit_layers:
        raise ValueError("a tier needs the exit layers l_ee1, l_ee2")
    if tier == "edge":
        return range(cfg.exit_layers[-1])
    return range(cfg.exit_layers[0], cfg.n_layers)


class Encoder(nn.Module):
    """Whisper's encoder: ``layers.<i>`` dense blocks without cross
    attention and the final ``norm`` (``scale`` and ``bias`` under a layer
    norm)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype,
                 axis: Optional[Axis] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderBlock(cfg, DENSE, device=device, dtype=dtype,
                         with_cross=False, axis=axis)
            for _ in range(cfg.encoder_layers))
        self.norm = _final_norm_params(cfg, device=device, dtype=dtype)


def _final_norm_params(cfg: ModelConfig, *, device, dtype):
    """A final norm's parameters: the rms ``(1 + scale)`` gain, or a layer
    norm's ``scale`` and ``bias``."""
    kw = dict(device=device, dtype=dtype)
    if cfg.norm_type == "layernorm":
        return nn.ParameterDict(
            {k: nn.Parameter(torch.empty(cfg.d_model, **kw))
             for k in ("scale", "bias")})
    return nn.Parameter(torch.empty(cfg.d_model, **kw))


@torch.no_grad()
def _init_final_norm(norm) -> None:
    if isinstance(norm, nn.ParameterDict):
        norm["scale"].fill_(1.0)
        norm["bias"].zero_()
    else:
        norm.zero_()                  # rms gains are (1 + scale)


def _run_block(block: nn.Module, cfg: ModelConfig, x: torch.Tensor,
               ctx: BlockCtx, cache):
    """``block_forward``, under activation checkpointing while autograd
    records (training: the block's activations are recomputed in the
    backward pass).  A block that writes a cache in place is never
    recomputed."""
    if cache is None and torch.is_grad_enabled():
        return checkpoint(block_forward, block, cfg, x, ctx,
                          use_reentrant=False)
    return block_forward(block, cfg, x, ctx, cache=cache)


def _apply_final_norm(norm, cfg: ModelConfig, x: torch.Tensor
                      ) -> torch.Tensor:
    if isinstance(norm, nn.ParameterDict):
        return layer_norm(x, norm["scale"], norm["bias"], cfg.norm_eps)
    return rms_norm(x, norm, cfg.norm_eps)


class Model(nn.Module):
    """Early-exit decoder of dense, MoE, recurrent (xLSTM) or hybrid
    (Mamba2 with a shared attention block) layers, with an encoder
    (whisper) or a vision prefix (paligemma) in front where configured.
    Parameter names follow the JAX package's pytree: ``embed``,
    ``layers.<i>.*``, ``shared.*``, ``final_norm`` (``final_norm.scale``
    and ``.bias`` under a layer norm), ``lm_head`` (untied only),
    ``exit_norms.<layer>``, ``encoder.layers.<i>.*`` and ``encoder.norm``
    (encoder-decoder only) and ``vis_proj`` (vision prefix only).  Every
    parameter is in ``dtype`` except the MoE routers and Mamba2's
    ``a_log``, ``dt_bias`` and ``d_skip``, which stay float32.  ``axis``:
    the model axis of a cloud-mesh rank, whose share this model is.
    ``tier``: ``"edge"`` or ``"cloud"`` for that partition alone (the
    module docstring), None for the whole model."""

    def __init__(self, cfg: ModelConfig, *, device, dtype=torch.float32,
                 axis: Optional[Axis] = None, tier: Optional[str] = None):
        super().__init__()
        self.cfg = cfg.validate()
        self.segments = build_segments(cfg)
        self.dtype = dtype
        if axis is not None and axis.size == 1:
            axis = None
        self.axis = axis
        self.tier = tier
        held = tier_layers(cfg, tier)
        self.held_segments = tuple(i for i, s in enumerate(self.segments)
                                   if s.start in held)
        other = {"edge": "cloud", "cloud": "edge"}.get(tier)
        edge, cloud = tier != "cloud", tier != "edge"
        self.kv_heads = head_split(cfg, axis).kv_heads
        kw = dict(device=device, dtype=dtype)
        d, v = cfg.d_model, cfg.vocab_size
        if axis is not None and v % axis.size == 0:
            v //= axis.size
        if edge or cfg.tie_embeddings:
            self.embed = nn.Parameter(torch.empty(v, d, **kw))
        self.layers = nn.ModuleList(
            OtherTier(i, other) if i not in held
            else nn.Identity() if kind == SHARED_ATTN
            else make_block(cfg, kind, device=device, dtype=dtype, axis=axis)
            for i, kind in enumerate(cfg.block_kinds()))
        if any(self.segments[si].shared for si in self.held_segments):
            self.shared = DecoderBlock(cfg, SHARED_ATTN, device=device,
                                       dtype=dtype, axis=axis)
        if cloud:
            self.final_norm = _final_norm_params(cfg, **kw)
        if cfg.is_encdec and edge:
            self.encoder = Encoder(cfg, axis=axis, **kw)
        if cfg.vision_tokens and edge:
            # column-parallel; its columns are gathered (embed_inputs)
            dv = d // axis.size if axis is not None and d % axis.size == 0 \
                else d
            self.vis_proj = nn.Parameter(torch.empty(d, dv, **kw))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(v, d, **kw))
        # per-exit read-out norms; the heads share the unembedding
        self.exit_norms = nn.ParameterDict(
            {str(l): nn.Parameter(torch.empty(d, **kw))
             for l in (cfg.exit_layers if edge else ())})
        self.shards = self._shards()

    @property
    def device(self) -> torch.device:
        return self.unembed_weight().device

    # ------------------------------------------------------------------
    # the rank's share
    # ------------------------------------------------------------------
    def _shards(self) -> Dict[str, Tuple[Tuple[int, ...], tuple]]:
        """{name: (whole shape, the rank's index)} of every parameter the
        constructors split over the model axis: the one dimension in
        which it is smaller than the single-device model's, of which the
        rank keeps its ``axis.block`` (a slice), or the positions its
        module's ``shares`` names (a list: a packed projection's parts).
        ``tests/test_torch_sharding.py`` holds these against the JAX
        package's rules and ``sharding.param_share``, leaf by leaf."""
        if self.axis is None:
            return {}
        whole = {n: tuple(p.shape) for n, p in
                 Model(self.cfg, device="meta").named_parameters()}
        shares = {}
        for prefix, mod in self.named_modules():
            for leaf, share in getattr(mod, "shares", {}).items():
                shares[f"{prefix}.{leaf}" if prefix else leaf] = share
        out = {}
        for name, p in self.named_parameters():
            shape = whole[name]
            split = [k for k, n in enumerate(shape) if n != p.shape[k]]
            if not split:
                continue
            (dim,) = split
            sl = [slice(None)] * len(shape)
            if name in shares:
                dim, sl[dim] = shares[name]
            else:
                sl[dim] = slice(*self.axis.block(shape[dim]))
            out[name] = (shape, tuple(sl))
        return out

    @contextlib.contextmanager
    def _whole(self, *params: torch.Tensor):
        """Within the block, the split ones of ``params`` have their whole
        shape (so an initializer draws what the single-device model
        draws); on leaving, each keeps the rank's slice again."""
        if not self.shards:
            yield
            return
        names = {id(p): n for n, p in self.named_parameters()}
        split = [(p, self.shards[names[id(p)]]) for p in params
                 if names.get(id(p)) in self.shards]
        for p, (shape, _) in split:
            p.data = torch.empty(shape, dtype=p.dtype, device=p.device)
        try:
            yield
        finally:
            for p, (_, sl) in split:
                # a copy: a slice's view would keep the whole tensor alive
                p.data = p.data[sl].clone()

    @torch.no_grad()
    def load_whole(self, state: Dict[str, torch.Tensor]) -> "Model":
        """Copy the rank's slice of each whole tensor of ``state`` (a
        single-device model's ``state_dict``) into this model."""
        for name, p in self.named_parameters():
            w = state[name]
            if name in self.shards:
                w = w[self.shards[name][1]]
            p.copy_(w)
        return self

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "Model":
        """Fill every parameter from ``gen`` with the JAX package's
        distributions (random weights: the repository has no trained 7B
        checkpoint).  A tier model takes its weights from the whole
        model (``load_whole``) instead: drawing its parameters alone would
        not give the whole model's."""
        if self.tier is not None:
            raise ValueError(f"the {self.tier} tier draws no weights of its "
                             f"own: load_whole(a whole model's state_dict)")
        cfg = self.cfg
        with self._whole(self.embed):
            embed_init_(self.embed, gen)
        for block in self.layers:
            if not isinstance(block, nn.Identity):
                with self._whole(*block.parameters()):
                    init_block(block, cfg, gen)
        if hasattr(self, "shared"):
            with self._whole(*self.shared.parameters()):
                init_block(self.shared, cfg, gen)
        _init_final_norm(self.final_norm)
        if not cfg.tie_embeddings:
            with self._whole(self.lm_head):
                embed_init_(self.lm_head, gen)
        for w in self.exit_norms.values():
            w.zero_()
        if cfg.is_encdec:
            for block in self.encoder.layers:
                with self._whole(*block.parameters()):
                    init_block(block, cfg, gen)
            _init_final_norm(self.encoder.norm)
        if cfg.vision_tokens:
            with self._whole(self.vis_proj):
                dense_init_(self.vis_proj, gen)
        return self

    # ------------------------------------------------------------------
    # norms / heads
    # ------------------------------------------------------------------
    @property
    def vocab_axis(self) -> Optional[Axis]:
        """The model axis when it splits the vocabulary, else None."""
        if self.unembed_weight().shape[0] == self.cfg.vocab_size:
            return None
        return self.axis

    def unembed_weight(self) -> torch.Tensor:
        """(V, d) read-out weight (tied or separate); under a model axis
        the rank's (V / M, d) vocabulary slice."""
        return self.embed if self.cfg.tie_embeddings else self.lm_head

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        w = self.unembed_weight()
        h = _apply_final_norm(self.final_norm, self.cfg, x)
        return gather_vocab(h @ w.to(x.dtype).T, self.axis,
                            self.cfg.vocab_size)

    def exit_logits(self, layer: int, x: torch.Tensor) -> torch.Tensor:
        """Full exit-head logits (the serving path takes the ``exit_head``
        kernel instead, which never writes them)."""
        h = rms_norm(x, self.exit_norms[str(layer)], self.cfg.norm_eps)
        return gather_vocab(h @ self.unembed_weight().to(x.dtype).T,
                            self.axis, self.cfg.vocab_size)

    # ------------------------------------------------------------------
    # embedding front-ends
    # ------------------------------------------------------------------
    def embed_tokens(self, tokens: torch.Tensor, pos_offset=0
                     ) -> torch.Tensor:
        """tokens (B, S) -> (B, S, d).  A model without rotary embeddings
        adds sinusoidal absolute positions from ``pos_offset``: an int or
        a per-row (B,) tensor of offsets (rows decode at their own
        positions)."""
        x = embed_lookup(self.embed, tokens, self.axis,
                         self.cfg.vocab_size).to(self.dtype)
        if not self.cfg.use_rope:
            s = tokens.shape[1]
            steps = torch.arange(s, device=x.device)
            off = torch.as_tensor(pos_offset, device=x.device)
            idx = off[:, None] + steps if off.dim() == 1 else off + steps
            x = x + sinusoidal_positions(idx, self.cfg.d_model).to(x.dtype)
        return x

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """Whisper's encoder over precomputed conv-frontend frames (B, Se,
        d): sinusoidal positions, non-causal dense blocks, the encoder's
        layer norm."""
        cfg = self.cfg
        x = frames.to(self.dtype)
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                     device=x.device).to(x.dtype)
        ctx = BlockCtx(positions=torch.arange(x.shape[1], device=x.device),
                       causal=False)
        with span("encode", x.device):
            for block in self.encoder.layers:
                x, _, _ = _run_block(block, cfg, x, ctx, None)
            return _apply_final_norm(self.encoder.norm, cfg, x)

    def embed_inputs(self, batch: Dict[str, torch.Tensor],
                     valid_len: Optional[int] = None
                     ) -> Tuple[torch.Tensor, BlockCtx]:
        """Prefill front-end: batch["tokens"] (B, S) int64, with
        batch["frames"] (B, Se, d) for an encoder-decoder model or
        batch["patches"] (B, P, d) for a vision prefix.  Returns the
        embedded sequence (B, S or P + S, d) and a context with its
        positions, ``enc_out`` and ``prefix_len`` = P (the patches come
        first, so a prompt's decode starts at position P + S)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        enc_out, prefix = None, 0
        if cfg.is_encdec:
            enc_out = self.encode(batch["frames"])
            x = self.embed_tokens(tokens)
        elif cfg.vision_tokens:
            vis = batch["patches"].to(self.dtype) @ self.vis_proj.to(
                self.dtype)
            dv = self.vis_proj.shape[1]
            vis = gather_heads(vis, self.axis,
                               slice(*self.axis.block(cfg.d_model))
                               if dv < cfg.d_model else slice(None),
                               cfg.d_model)
            x = torch.cat([vis, self.embed_tokens(tokens)], dim=1)
            prefix = vis.shape[1]
        else:
            x = self.embed_tokens(tokens)
        ctx = BlockCtx(positions=torch.arange(x.shape[1], device=x.device),
                       enc_out=enc_out, prefix_len=prefix,
                       valid_len=valid_len)
        return x, ctx

    # ------------------------------------------------------------------
    # segment execution
    # ------------------------------------------------------------------
    def block(self, si: int, j: int) -> nn.Module:
        """Layer j of segment si: the shared block for a shared segment
        (the JAX package's ``_seg_params``).  Raises for a segment of the
        other tier."""
        seg = self.segments[si]
        if si not in self.held_segments:
            other = "cloud" if self.tier == "edge" else "edge"
            raise OtherTierError(
                f"segment {si} (layers {seg.start + 1}..{seg.end}) is held "
                f"by the {other} tier, not the {self.tier} tier")
        return self.shared if seg.shared else self.layers[seg.start + j]

    def run_segments(self, x: torch.Tensor, ctx: BlockCtx,
                     seg_indices: Sequence[int],
                     caches: Optional[Caches] = None,
                     collect_exits: bool = True):
        """Full-sequence execution of the given segments.  While autograd
        records and no cache is given, each block runs under activation
        checkpointing (``_run_block``).

        Returns (x, exit_hiddens {1-based layer: hidden}, the MoE blocks'
        auxiliary losses summed (a float32 scalar tensor; 0.0 without a
        MoE block), caches)."""
        cfg = self.cfg
        exit_set = set(cfg.exit_layers) if collect_exits else set()
        exit_hiddens: Dict[int, torch.Tensor] = {}
        aux_total = 0.0
        with span("prefill", x.device):
            for si in seg_indices:
                seg = self.segments[si]
                sctx = dataclasses.replace(ctx, window=seg.window)
                for j in range(seg.length):
                    cache = caches[si][j] if caches is not None else None
                    x, aux, _ = _run_block(self.block(si, j), cfg, x, sctx,
                                           cache)
                    aux_total = aux_total + aux
                if seg.end in exit_set:
                    exit_hiddens[seg.end] = x
        return x, exit_hiddens, aux_total, caches

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
                block = self.block(si, j)
                work = "attention" if block.kind in ATTN_KINDS else "recurrent"
                with span(work, x.device):
                    x, _ = block_decode(block, cfg, x, caches[si][j], sctx)
            if seg.end in exit_set:
                exit_hiddens[seg.end] = x
        return x, exit_hiddens, caches

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int,
                   seg_indices: Optional[Sequence[int]] = None) -> Caches:
        """Dense caches of ``batch`` rows: self-attention rings of
        ``max_seq`` slots (a vision prefix's patches take slots too),
        an encoder-decoder's cross entries of ``encoder_seq`` keys, and
        recurrent state; by default of every segment the model holds."""
        seg_indices = (self.held_segments if seg_indices is None
                       else seg_indices)
        return {si: [init_block_cache(self.cfg, batch, max_seq,
                                      self.segments[si].window,
                                      kind=self.segments[si].kind,
                                      device=self.device, dtype=self.dtype,
                                      kv_heads=self.kv_heads, axis=self.axis)
                     for _ in range(self.segments[si].length)]
                for si in seg_indices}

    def init_paged_cache(self, num_pages: int, page_size: int,
                         seg_indices: Optional[Sequence[int]] = None,
                         kv_dtype: str = "float32",
                         batch: int = 0) -> Caches:
        """Block-paged caches: self-attention K/V is pooled across rows in
        ``num_pages`` pages of ``page_size`` tokens (plus a trash page) and
        addressed through a per-row block table passed to ``decode_step``
        (the pool has no batch axis).  ``kv_dtype="int8"`` stores pages
        quantized with per-row scales; otherwise in the model's dtype.
        Recurrent state stays dense per row: ``batch`` rows, which a
        partition with recurrent layers must name."""
        seg_indices = (self.held_segments if seg_indices is None
                       else seg_indices)
        if batch < 1 and not self.attention_only(seg_indices):
            raise ValueError("recurrent layers keep dense per-row state: "
                             "init_paged_cache needs batch >= 1")
        if batch < 1 and self.cfg.is_encdec:
            raise ValueError("cross-attention keeps a dense per-row cross "
                             "entry: init_paged_cache needs batch >= 1")
        return {si: [init_block_cache_paged(self.cfg, num_pages, page_size,
                                            kind=self.segments[si].kind,
                                            batch=batch, device=self.device,
                                            dtype=self.dtype,
                                            kv_dtype=kv_dtype,
                                            kv_heads=self.kv_heads,
                                            axis=self.axis)
                     for _ in range(self.segments[si].length)]
                for si in seg_indices}

    def attention_only(self, seg_indices: Optional[Sequence[int]] = None
                       ) -> bool:
        """True when every segment is attention-style (KV-cached).  Such
        partitions tolerate right-padded prefill: pad positions are
        causally invisible to real tokens and their cache entries can be
        invalidated afterwards.  Recurrent (SSM/xLSTM) segments cannot:
        their state advances through pad tokens irreversibly."""
        seg_indices = (range(len(self.segments)) if seg_indices is None
                       else seg_indices)
        return all(self.segments[si].kind in ATTN_KINDS
                   for si in seg_indices)

    def invalidate_cache_after(self, caches: Caches, true_len: int) -> Caches:
        """Mark self-attention ring slots >= true_len invalid (pos = -1),
        in place — used after a right-padded prefill so pad positions never
        take part in decode attention.  Recurrent state and cross entries
        are left alone."""
        for layers in caches.values():
            for c in layers:
                if "self" in c:
                    c["self"]["pos"][:, true_len:] = -1
        return caches

    def whole_state(self, caches: Caches) -> Caches:
        """The recurrent state in ``caches`` as the single-device model
        holds it ({segment: [state of each layer]}, recurrent segments
        only): under a model axis each leaf the rank keeps a share of is
        gathered over the group (``gather_heads``), so a state packet built
        from it (``transport.make_packet``) dequantizes to the single
        device's values and weighs what the single device's does."""
        out = {}
        for si, layers in caches.items():
            if self.segments[si].kind in ATTN_KINDS:
                continue
            out[si] = [cache_tree.map_named(
                c, self.block(si, j).whole_state_leaf)
                for j, c in enumerate(layers)]
        return out

    def reset_state(self, caches: Caches) -> Caches:
        """Zero the recurrent state of ``caches`` in place: a prefill into
        a reused single-row cache starts a new stream from the empty state
        (every admission of the JAX package prefills a fresh zero cache).
        Attention caches (self and cross) are left alone."""
        for layers in caches.values():
            for c in layers:
                if "self" not in c:
                    cache_tree.zero(c)
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
                seg_indices: Optional[Sequence[int]] = None,
                valid_len: Optional[int] = None):
        """Full-sequence pass that fills caches.  batch: ``embed_inputs``'
        (tokens (B, S) int64, and frames or patches where configured);
        ``valid_len``: the real length of a right-padded prompt (a
        windowed ring keeps real tokens, not pads).  Returns (hidden
        (B, S or P + S, d), exit_hiddens, caches, ctx); ``ctx.enc_out`` is
        the encoder's output (what the edge uploads to the cloud once)."""
        seg_indices = seg_indices or self.all_segments()
        x, ctx = self.embed_inputs(batch, valid_len)
        x, exit_hiddens, _, caches = self.run_segments(x, ctx, seg_indices,
                                                       caches=caches)
        return x, exit_hiddens, caches, ctx

    def forward_train_hiddens(self, batch: Dict[str, torch.Tensor]
                              ) -> Dict[str, Any]:
        """Training forward that stops at the hidden states (no
        unembedding): {"final": (B, S', d), "exits": {layer: (B, S', d)},
        "aux_loss": float32 scalar, "prefix_len": P}, S' = P + S for a
        vision prefix.  Pairs with ``multi_exit_loss_fused``."""
        x, ctx = self.embed_inputs(batch)
        x, exit_hiddens, aux, _ = self.run_segments(x, ctx,
                                                    self.all_segments())
        aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
        return {"final": x, "exits": exit_hiddens, "aux_loss": aux,
                "prefix_len": ctx.prefix_len}

    def forward_train(self, batch: Dict[str, torch.Tensor]
                      ) -> Dict[str, Any]:
        """Full forward with every head's logits (multi-exit training):
        {"logits": (B, S', V), "exit_logits": {layer: (B, S', V)},
        "aux_loss", "prefix_len"}."""
        out = self.forward_train_hiddens(batch)
        return {"logits": self.logits(out["final"]),
                "exit_logits": {l: self.exit_logits(l, h)
                                for l, h in out["exits"].items()},
                "aux_loss": out["aux_loss"],
                "prefix_len": out["prefix_len"]}

    def _rows_pos(self, pos, b: int) -> torch.Tensor:
        """A scalar or per-row position as a (B,) int32 device tensor."""
        return torch.as_tensor(pos, dtype=torch.int32, device=self.device
                               ).broadcast_to((b,)).contiguous()

    def _decode_ctx(self, pos, b: int, block_tbl, write_mask) -> BlockCtx:
        """A decode step's context: (B,) positions and, for an
        encoder-decoder model, the cross decode's cur = encoder_seq - 1."""
        cross_pos = None
        if self.cfg.is_encdec:
            cross_pos = torch.full((b,), self.cfg.encoder_seq - 1,
                                   dtype=torch.int32, device=self.device)
        return BlockCtx(pos=self._rows_pos(pos, b), block_tbl=block_tbl,
                        write_mask=write_mask, cross_pos=cross_pos)

    def decode_step(self, token: torch.Tensor, caches: Caches, pos,
                    seg_indices: Optional[Sequence[int]] = None,
                    collect_exits: bool = True,
                    block_tbl: Optional[torch.Tensor] = None,
                    write_mask: Optional[torch.Tensor] = None):
        """token: (B,1); pos: scalar or per-row (B,) position ->
        (final hidden (B,1,d), exit_hiddens, caches).  A vision-prefix
        row's first decode position is P + len(prompt).  Paged caches
        need ``block_tbl`` (B, max_logical) int32 on the model's device;
        ``write_mask`` (B,) bool leaves the masked-out rows' KV as it
        was.  With paged caches ``token`` may also be a (B,C) chunk whose
        first position is ``pos`` (chunked prefill), and ``write_mask``
        then (B,C) per token."""
        seg_indices = seg_indices or self.all_segments()
        ctx = self._decode_ctx(pos, token.shape[0], block_tbl, write_mask)
        x = self.embed_tokens(token, pos_offset=ctx.pos)
        return self.decode_segments(x, ctx, seg_indices, caches,
                                    collect_exits=collect_exits)

    def decode_from_hidden(self, hidden: torch.Tensor, caches: Caches, pos,
                           seg_indices: Sequence[int],
                           block_tbl: Optional[torch.Tensor] = None,
                           write_mask: Optional[torch.Tensor] = None):
        """Cloud-partition decode: continue from an uploaded hidden state
        (B,1,d), or with paged caches a (B,C,d) chunk starting at ``pos``
        (``write_mask`` (B,) or (B,C), as ``decode_step``)."""
        ctx = self._decode_ctx(pos, hidden.shape[0], block_tbl, write_mask)
        return self.decode_segments(hidden, ctx, seg_indices, caches,
                                    collect_exits=False)
