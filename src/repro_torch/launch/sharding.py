"""Role-based sharding rules of the cloud mesh, and the collectives that
the model's blocks call (port of ``repro.launch.sharding``).

The rules are the JAX package's, over plain shapes and names: a leaf is
its path (a tuple of names, ``("segments", "0", "attn", "wq")``) and its
shape, a mesh anything with ``axis_names`` and a ``shape`` dict (a
``MeshShape``, a ``launch.mesh.CloudMesh``, the JAX tests' ``FakeMesh``).
A spec is a tuple in ``PartitionSpec``'s order: ``()`` for a replicated
leaf, else one entry a dimension, ``None``, an axis name or a tuple of
axis names.

  * params: tensor-parallel on heads / d_ff / experts' d_ff / vocab over
    ``model`` (``wq wk wv w_gate w_up w1`` column-parallel, ``wo w_down
    w2`` row-parallel, ``embed`` / ``lm_head`` over the vocabulary);
    attention projections only when the head count divides the model
    axis; routers and every 1-D leaf (norms, biases) replicated;
    optional FSDP over ``data`` (and ``pod``).
  * caches: batch over ``("pod", "data")``, KV sequence or KV heads over
    ``model`` (``cache_pspec``); inputs: batch over the data axes.

The port's tensor-parallel model (``repro_torch.models``) keeps the KV
heads of its query heads, not a sequence shard, in its caches, and keeps
activations replicated between blocks: the JAX package's
sequence-parallel residual (``ShardingPolicy``) is a layout choice of
GSPMD with no effect on results, so it has no counterpart here.  What a
rank keeps of a full tensor is ``rank_slices``.

The collectives take an ``Axis`` (a rank's place on one mesh axis and
its process group) and are the identity without one, so the
single-device model runs the same code.  They use only ``all_reduce``:
over NCCL on the cards' tensors, over gloo (ranks that share one card,
or the CPU) on host tensors, a card's tensor staged through host memory
(``Axis.staged``).  Sums are taken in float32.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterable, Optional, Sequence, Tuple

import torch

Spec = Tuple[Any, ...]
AXES = ("data", "model")        # the cloud mesh's axes, major to minor


# --------------------------------------------------------------------------
# meshes as shapes
# --------------------------------------------------------------------------
class MeshShape:
    """A mesh by its shape alone: ``MeshShape((2, 4), ("data", "model"))``."""

    def __init__(self, shape: Sequence[int], names: Sequence[str]):
        self.axis_names = tuple(names)
        self.dims = tuple(int(s) for s in shape)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))


def _sizes(mesh) -> dict:
    return dict(mesh.shape)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = _sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _fits(dim: int, mesh, axes) -> bool:
    return axes is not None and dim % _axis_size(mesh, axes) == 0 \
        and _axis_size(mesh, axes) > 1


def batch_axes(mesh, b: int):
    """Largest prefix of ("pod","data") that divides the batch."""
    cands = [ax for ax in ("pod", "data") if ax in mesh.axis_names]
    for trial in (tuple(cands), ("data",), None):
        if trial is None:
            return None
        if b % _axis_size(mesh, trial) == 0:
            return trial
    return None


# --------------------------------------------------------------------------
# parameter specs
# --------------------------------------------------------------------------
_COL_PARALLEL = {"wq", "wk", "wv", "w_gate", "w_up", "w1", "ffn_up", "w_in",
                 "vis_proj"}          # shard OUTPUT dim over model
_ROW_PARALLEL = {"wo", "w_down", "w2", "ffn_down", "w_out"}  # shard INPUT dim
_EMBED = {"embed", "lm_head"}
_ATTN_PROJ = {"wq", "wk", "wv", "wo"}   # reshaped to (.., heads, head_dim)


def param_pspec(names: Sequence[str], shape: Sequence[int], mesh, *,
                fsdp: bool, head_dim: int = 0) -> Spec:
    """The spec of the parameter leaf at path ``names`` of ``shape``.
    ``head_dim`` > 0 restricts attention projections to head-aligned
    model sharding: the flattened heads*head_dim dim is only sharded when
    the HEAD COUNT divides the model axis."""
    names = tuple(str(n) for n in names)
    shape = tuple(shape)
    name = names[-1] if names else ""
    in_segment = "segments" in names or "layers" in names
    nd = len(shape)
    stack = 1 if in_segment and nd >= 1 else 0   # leading layer axis
    spec = [None] * nd
    fsdp_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names) \
        if fsdp else None

    def put(dim, axes):
        if 0 <= dim < nd and spec[dim] is None and _fits(shape[dim], mesh,
                                                         axes):
            spec[dim] = axes if isinstance(axes, str) else tuple(axes)
            return True
        return False

    def heads_align(dim) -> bool:
        if head_dim <= 0 or name not in _ATTN_PROJ:
            return True
        heads, rem = divmod(shape[dim], head_dim)
        return rem == 0 and heads % _axis_size(mesh, "model") == 0

    if nd - stack < 2:
        return ()                       # norms / biases replicated
    if name in _EMBED:
        put(0, "model")
        if fsdp_axes:
            put(1, fsdp_axes)
        return tuple(spec)
    if name in _COL_PARALLEL:
        if heads_align(nd - 1):
            put(nd - 1, "model")
        if fsdp_axes:
            put(nd - 2, fsdp_axes)
        return tuple(spec)
    if name in _ROW_PARALLEL:
        if heads_align(nd - 2):
            put(nd - 2, "model")
        if fsdp_axes:
            put(nd - 1, fsdp_axes)
        return tuple(spec)
    if name == "router":
        return ()
    # fallback: greedy — model on largest shardable dim, fsdp on next
    order = sorted(range(stack, nd), key=lambda i: -shape[i])
    for i in order:
        if put(i, "model"):
            break
    if fsdp_axes:
        for i in order:
            if put(i, fsdp_axes):
                break
    return tuple(spec)


def layer_pspec(names: Sequence[str], shape: Sequence[int], mesh, *,
                fsdp: bool = False, head_dim: int = 0) -> Spec:
    """``param_pspec`` of one of the port's parameters, named as in its
    state dict (``layers.3.attn.wq``): a layer's parameter is one slice
    of the JAX package's stacked segment leaf, so the rule sees it with a
    leading layer axis of 1, which is dropped again."""
    names = tuple(names)
    if "layers" not in names:
        return param_pspec(names, shape, mesh, fsdp=fsdp, head_dim=head_dim)
    spec = param_pspec(names, (1,) + tuple(shape), mesh, fsdp=fsdp,
                       head_dim=head_dim)
    return spec[1:] if spec else ()


# --------------------------------------------------------------------------
# cache specs
# --------------------------------------------------------------------------
def cache_pspec(names: Sequence[str], shape: Sequence[int], mesh, *,
                batch: int) -> Spec:
    """Cache layouts (leading stacked-layer axis L for scanned segments):
       k/v:  (L?, B, S, KV, hd)   pos: (L?, B, S)
       gla S:(L?, B, H, dk, dv)   n: (L?, B, H, dk)   m: (L?, B, H)
       conv: (L?, B, W, di)       slstm c/n/m/h: (L?, B, H, hd)
    Paged pools are page-major with no batch axis:
       kp/vp: (L?, P, ps, KV, hd)   ks/vs: (L?, P, ps, KV)
       pos:   (L?, P, ps) — told apart from dense pos by the batch dim.
    Page axis over ("pod","data"); KV heads over "model" when they
    divide, else replicated; the in-page token axis never."""
    names = tuple(str(n) for n in names)
    shape = tuple(shape)
    name = names[-1] if names else ""
    nd = len(shape)
    spec = [None] * nd
    baxes = batch_axes(mesh, batch)

    def put(dim, axes):
        if axes is None or not (0 <= dim < nd) or spec[dim] is not None:
            return False
        if _fits(shape[dim], mesh, axes):
            spec[dim] = axes if isinstance(axes, str) else tuple(axes)
            return True
        return False

    if name in ("kp", "vp"):
        pdim, kvdim = nd - 4, nd - 2
    elif name in ("ks", "vs"):
        pdim, kvdim = nd - 3, nd - 1
    elif name == "pos" and nd >= 2 and shape[nd - 2] != batch:
        pdim, kvdim = nd - 2, None      # paged pos: (L?, P, ps)
    else:
        pdim = None
    if pdim is not None:
        for trial in (("pod", "data"), ("data",)):
            axes = tuple(a for a in trial if a in mesh.axis_names)
            if axes and put(pdim, axes):
                break
        if kvdim is not None:
            put(kvdim, "model")
        return tuple(spec)

    if name in ("k", "v"):
        bdim, sdim = nd - 4, nd - 3
    elif name == "pos":
        bdim, sdim = nd - 2, nd - 1
    elif name == "S":
        bdim, sdim = nd - 4, None
    elif name in ("n", "conv", "c", "h"):
        bdim, sdim = nd - 3, None
    elif name == "m":
        bdim, sdim = nd - 2 if nd >= 2 else 0, None
    else:
        bdim, sdim = None, None

    if bdim is not None and shape[bdim] == batch and baxes is not None:
        put(bdim, baxes)
    if sdim is not None:
        if baxes is None:
            for trial in (("pod", "data", "model"), ("data", "model"),
                          ("model",)):
                axes = tuple(a for a in trial if a in mesh.axis_names)
                if put(sdim, axes):
                    break
        else:
            put(sdim, "model")
    elif name in ("S", "n", "conv", "c", "h", "m"):
        order = sorted(range(nd), key=lambda i: -shape[i])
        for i in order:
            if i == bdim:
                continue
            if put(i, "model"):
                break
    return tuple(spec)


def input_pspec(shape: Sequence[int], mesh, batch: int) -> Spec:
    baxes = batch_axes(mesh, batch)
    if len(shape) == 0 or baxes is None or shape[0] != batch:
        return ()
    return (baxes,) + (None,) * (len(shape) - 1)


def estimate_param_bytes_per_device(leaves: Iterable[tuple], mesh,
                                    fsdp: bool, head_dim: int = 0) -> float:
    """Bytes of parameters a device holds; ``leaves`` yields (path names,
    shape, itemsize) in the JAX package's pytree (stacked segments)."""
    total = 0.0
    for names, shape, itemsize in leaves:
        spec = param_pspec(names, shape, mesh, fsdp=fsdp, head_dim=head_dim)
        shards = 1
        for s in spec:
            if s:
                shards *= _axis_size(mesh, s)
        n = 1
        for dim in shape:
            n *= dim
        total += n * itemsize / shards
    return total


# --------------------------------------------------------------------------
# what a rank keeps
# --------------------------------------------------------------------------
def rank_slices(spec: Spec, shape: Sequence[int], mesh,
                coords: dict) -> Tuple[slice, ...]:
    """The slices of a full tensor of ``shape`` that the rank at
    ``coords`` ({axis name: index}) keeps under ``spec``: a dimension
    split over axes (a, b, ...) is cut into size(a) * size(b) * ...
    blocks, indexed major to minor."""
    sizes = _sizes(mesh)
    out = []
    for dim, n in enumerate(shape):
        axes = spec[dim] if dim < len(spec) else None
        if not axes:
            out.append(slice(None))
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx, parts = 0, 1
        for a in axes:
            idx = idx * sizes[a] + coords[a]
            parts *= sizes[a]
        step = n // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class Axis:
    """A rank's place on one mesh axis: its ``index``, the axis ``size``
    and the process ``group`` of the ranks along it.  ``staged``: the
    group's backend (gloo for ranks that share a card) sums host tensors,
    so a card's tensor goes through host memory and back."""
    index: int
    size: int
    group: Any = None
    staged: bool = False

    def block(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's share of ``n`` (n a multiple of size)."""
        step = n // self.size
        return self.index * step, (self.index + 1) * step


# collective calls made by this process, by kind, and the host seconds
# spent in them (``reset_counts`` zeroes both)
_KINDS = ("reduce_model", "embed_lookup", "gather_vocab", "merge_exits",
          "gather_rows")
COUNTS = dict.fromkeys(_KINDS, 0)
SECONDS = dict.fromkeys(_KINDS, 0.0)


def reset_counts() -> None:
    for k in _KINDS:
        COUNTS[k], SECONDS[k] = 0, 0.0


def _all_reduce(x: torch.Tensor, axis: Axis, kind: str) -> torch.Tensor:
    import torch.distributed as dist
    t0 = time.perf_counter()
    if axis.staged and x.is_cuda:
        host = x.cpu()
        dist.all_reduce(host, group=axis.group)
        x.copy_(host)
    else:
        dist.all_reduce(x, group=axis.group)
    SECONDS[kind] += time.perf_counter() - t0
    COUNTS[kind] += 1
    return x


def _live(axis: Optional[Axis]) -> bool:
    return axis is not None and axis.size > 1


def reduce_model(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Sum of the model group's partial products (after a row-parallel
    product), in float32, returned in ``x``'s dtype."""
    if not _live(axis):
        return x
    return _all_reduce(x.float(), axis, "reduce_model").to(x.dtype)


def embed_lookup(weight: torch.Tensor, tokens: torch.Tensor,
                 axis: Optional[Axis], vocab: int) -> torch.Tensor:
    """Rows of a vocabulary-split (V / M, d) table for ``tokens``: each
    rank looks up the tokens of its slice (zeros elsewhere), then the
    model group sums, which is exact.  Without a split it is
    ``weight[tokens]``."""
    if not _live(axis) or weight.shape[0] == vocab:
        return weight[tokens]
    lo = axis.index * weight.shape[0]
    local = tokens - lo
    mine = (local >= 0) & (local < weight.shape[0])
    x = weight[local.clamp(0, weight.shape[0] - 1)].float()
    x = x * mine[..., None]
    return _all_reduce(x, axis, "embed_lookup").to(weight.dtype)


def gather_vocab(logits: torch.Tensor, axis: Optional[Axis],
                 vocab: int) -> torch.Tensor:
    """(..., V / M) logits of each rank's vocabulary slice -> (..., V) on
    every rank: a zero buffer, each rank writes its slice, the group
    sums (exact)."""
    if not _live(axis) or logits.shape[-1] == vocab:
        return logits
    vl = logits.shape[-1]
    full = logits.new_zeros(logits.shape[:-1] + (vocab,), dtype=torch.float32)
    full[..., axis.index * vl:(axis.index + 1) * vl] = logits
    return _all_reduce(full, axis, "gather_vocab").to(logits.dtype)


def merge_exits(conf: torch.Tensor, tok: torch.Tensor, lse: torch.Tensor,
                axis: Optional[Axis], vocab_local: int):
    """Merge the exit heads of each rank's vocabulary slice: (conf, tok,
    lse), each (E, B), of the local slice -> the same of the whole
    vocabulary on every rank.  A row's max logit is log(conf) + lse; the
    global lse is the logsumexp of the ranks' lse; the token is the
    local argmax plus its rank's offset, the lowest rank winning a tie;
    conf = exp(max - lse).  One sum over the group carries every rank's
    three numbers a row.  The rebuilt max logit carries about one ulp of
    the lse in rounding (near 1e-6 at lse 12 in float32), while a single
    device compares the raw logits: where two ranks' slices tie closer
    than that, the merged token can differ from the single device's
    (ROADMAP §C)."""
    if not _live(axis):
        return conf, tok, lse
    mx = torch.log(conf) + lse
    parts = torch.zeros((axis.size, 3) + tuple(conf.shape),
                        dtype=torch.float32, device=conf.device)
    parts[axis.index, 0] = mx
    parts[axis.index, 1] = lse
    parts[axis.index, 2] = (tok.long() + axis.index * vocab_local).float()
    _all_reduce(parts, axis, "merge_exits")
    best, who = parts[:, 0].max(dim=0)
    glse = torch.logsumexp(parts[:, 1], dim=0)
    token = parts[:, 2].gather(0, who[None])[0].to(torch.int32)
    return torch.exp(best - glse), token, glse


def gather_rows(x: torch.Tensor, axis: Optional[Axis], lo: int,
                batch: int) -> torch.Tensor:
    """A data column's rows [lo, lo + len(x)) of a (batch, ...) result ->
    the whole batch on every rank of the data group (a zero buffer and a
    sum, exact)."""
    if not _live(axis) or x.shape[0] == batch:
        return x
    full = torch.zeros((batch,) + tuple(x.shape[1:]), dtype=torch.float32,
                       device=x.device)
    full[lo:lo + x.shape[0]] = x
    return _all_reduce(full, axis, "gather_rows").to(x.dtype)
