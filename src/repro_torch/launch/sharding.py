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
rank keeps of a full tensor is ``rank_slices``, except where the port
departs from the rules (``param_share``, ``cache_share``; the rule
functions themselves stay the JAX package's).  A recurrent block is split
by its heads (whole on every rank where the axis does not divide them);
GSPMD's one contiguous block of a packed dimension would give one rank
``xi`` and the other ``z``, so the port keeps each part's share instead:

  * mLSTM ``w_up`` (d, 2 di): the ``xi`` half whole (it feeds every head's
    q, k, v and gates through (di, di) products), the rank's heads of the
    ``z`` half (rule: 2 di in one block); ``conv`` (W, di): whole (rule: di
    split); ``w_if`` (di, 2 h): the rank's heads of both gate halves
    (rule: rows split); ``b_if`` (2 h): the same (rule: whole);
    ``head_norm`` (h, hd): the rank's heads (rule: hd split).  ``wq`` /
    ``wk`` / ``wv`` (columns) and ``w_down`` (rows) follow the rule.
  * sLSTM ``wz wi wf wo`` (d, d): the rank's heads' columns (rule: rows);
    ``rz ri rf ro`` (h, hd, hd): the rank's heads (rule: the first hd);
    ``b_*`` (d): the rank's heads (rule: whole); ``head_norm`` as mLSTM's;
    ``ffn_up`` (d, 2 f_ff): whole (rule: columns; ``f_ff = int(4d/3)``
    divides no model axis, so ``ffn_down`` is whole by the rule too).
  * Mamba2 ``w_in`` (d, 2 di + 2 n + h), packed ``[z | x | B | C | dt]``:
    the rank's heads of ``z``, ``x`` and ``dt``, ``B`` and ``C`` whole
    (every head reads them; rule: one block); ``conv`` (W, di + 2 n) and
    ``conv_bias``: the rank's ``x`` channels and the whole B, C (rule:
    one block, and whole); ``a_log`` / ``dt_bias`` / ``d_skip`` (h) and
    ``gate_norm`` (di): the rank's heads (rule: whole).  ``w_out`` (rows)
    follows the rule.
  * caches: dense and cross K/V keep the rank's KV heads (rule: the
    sequence over ``model``); a recurrent state (GLA ``S`` / ``n`` /
    ``m``, sLSTM ``c`` / ``n`` / ``m`` / ``h``) keeps the rank's heads
    (rule: the largest non-batch dimension, inside a head for ``S`` and
    the sLSTM states); the mLSTM conv tail is whole, Mamba2's keeps the
    rank's ``x`` channels beside the whole B, C.  Paged pools follow the
    rule on a ``(1, M)`` mesh (KV heads over ``model``).  Over a data
    axis of D that divides the pool's rows and its pages, the page axis
    is split as the rule splits it, except that each column keeps a trash
    page of its own (so a masked write stays local): a column holds
    ``P / D + 1`` pages, its block of the allocator's ids
    (``core/paging.PagePool(columns=)``); else the pool stays whole in
    every column, each column writing only its rows' pages.

Where the split pool departs from GSPMD's: under the rule any row reads
any page, since the page axis is one array; in the port a row reads only
its column's pages, so a column admits only into its own block, and a
stream can wait for pages while another column has room.  A page that
must cross columns (a swap snapshot, a prefix-cache hit on another
column's pages) crosses through one sum over the data axis
(``share_column``).

Everything else of the four families follows the rules: the shared
attention block's and the encoder's attention and FFN, cross-attention,
``vis_proj`` (columns; its output is gathered), whisper's odd vocabulary
(whole: 51865 divides no axis).  ``rank_param_bytes`` is a rank's bytes
under these shares, ``estimate_param_bytes_per_device`` the rules'.

The collectives take an ``Axis`` (a rank's place on one mesh axis and
its process group) and are the identity without one, so the
single-device model runs the same code; each is counted under a kind
of its own (``COUNTS``, ``SECONDS``), and its group size and tensor
bytes recorded (``CALLS``, ``records``: what
``roofline/collectives.wire_bytes`` takes), and none is called inside a
per-token loop (the sLSTM gathers its heads once a call, after its time
loop).  They use only ``all_reduce``:
over NCCL on the cards' tensors, over gloo (ranks that share one card,
or the CPU) on host tensors, a card's tensor staged through host memory
(``Axis.staged``).  Sums are taken in float32.

A recording axis (``recording_axis``, the group ``RECORDING``) stands in
for a rank's groups where nothing runs (the dry run of
``launch/dryrun_collm.py``, on tensors without storage): a sum over it
is recorded like any other and communicates nothing; its result is its
input, of the right shape and dtype.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

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
# where the port's shares depart from the rules
# --------------------------------------------------------------------------
_RECURRENT_KINDS = ("mlstm", "slstm", "mamba2")
_SLSTM_GATES = ("z", "i", "f", "o")


def recurrent_dims(kind: str, cfg) -> Tuple[int, int, int, int]:
    """(inner width, heads, head dim, state size) of a recurrent block of
    ``kind``: the models' ``mlstm_dims``, ``slstm_dims``, ``mamba2_dims``
    (imported here, since the models import this module)."""
    from repro_torch.models.mamba2 import mamba2_dims
    from repro_torch.models.xlstm import mlstm_dims, slstm_dims
    if kind == "mlstm":
        return mlstm_dims(cfg) + (0,)
    if kind == "slstm":
        h, hd = slstm_dims(cfg)
        return cfg.d_model, h, hd, 0
    di, n, h, hp = mamba2_dims(cfg)
    return di, h, hp, n


def head_share(heads: int, axis: Optional["Axis"]
               ) -> Tuple[int, int, Optional["Axis"]]:
    """(first head, heads, axis) of a rank's share of a recurrent block's
    ``heads`` heads: the axis's block when the heads divide it, else every
    head and no axis (the block is whole on every rank)."""
    if axis is None or axis.size == 1 or heads % axis.size:
        return 0, heads, None
    lo, hi = axis.block(heads)
    return lo, hi - lo, axis


def param_share(kind: Optional[str], name: str, shape: Sequence[int], cfg,
                m: int) -> Optional[Tuple[int, ...]]:
    """The local shape a rank of a model axis of ``m`` keeps of parameter
    ``name`` (its last name) of whole ``shape`` in a block of ``kind``,
    where the port departs from ``param_pspec``; None where it keeps the
    rule's share.  A recurrent block whose heads the axis does not divide
    is whole on every rank."""
    if kind not in _RECURRENT_KINDS:
        return None
    shape = tuple(shape)
    di, h, hd, n = recurrent_dims(kind, cfg)
    if h % m:
        return shape
    hl = h // m
    if kind == "mlstm":
        out = {"w_up": (shape[0], di + di // m), "conv": shape,
               "w_if": (di, 2 * hl), "b_if": (2 * hl,),
               "head_norm": (hl, hd)}
    elif kind == "slstm":
        out = {"head_norm": (hl, hd), "ffn_up": shape}
        for g in _SLSTM_GATES:
            out.update({"w" + g: (di, di // m), "r" + g: (hl, hd, hd),
                        "b_" + g: (di // m,)})
    else:
        out = {"w_in": (shape[0], 2 * di // m + 2 * n + hl),
               "conv": (shape[0], di // m + 2 * n),
               "conv_bias": (di // m + 2 * n,), "a_log": (hl,),
               "dt_bias": (hl,), "d_skip": (hl,), "gate_norm": (di // m,)}
    return out.get(name)


def cache_share(kind: str, name: str, shape: Sequence[int], cfg,
                m: int) -> Tuple[int, ...]:
    """The local shape a rank of a model axis of ``m`` keeps of one cache
    leaf ``name`` of whole ``shape`` of a layer of ``kind``: an attention
    layer's (dense, cross or paged) K/V and int8 scales its KV heads
    (``head_split``'s), its markers whole; a recurrent state its heads
    (dimension 1, batch first), a conv tail whole (mLSTM: ``xi`` is whole)
    or its ``x`` channels beside the whole B and C (Mamba2)."""
    shape = list(shape)
    if kind in _RECURRENT_KINDS:
        di, h, _, n = recurrent_dims(kind, cfg)
        if h % m:
            return tuple(shape)
        if name == "conv":
            if kind == "mamba2":
                shape[-1] = di // m + 2 * n
        else:
            shape[1] = h // m
        return tuple(shape)
    if name == "pos":
        return tuple(shape)
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if h % m == 0:
        local = kv // m if kv % m == 0 else max(1, (h // m) // (h // kv))
        shape[-1 if name in ("ks", "vs") else -2] = local
    return tuple(shape)


def rank_param_bytes(leaves: Iterable[tuple], mesh, cfg) -> float:
    """Bytes of parameters a rank of ``mesh``'s model axis holds of
    ``cfg``'s model (no FSDP, head-aligned): ``leaves`` yields (the port's
    parameter name split at dots, whole shape, itemsize, block kind or
    None); a leaf's share is ``param_share``'s where the port departs from
    the rules, else ``layer_pspec``'s."""
    m = _axis_size(mesh, "model")
    total = 0.0
    for names, shape, itemsize, kind in leaves:
        local = param_share(kind, names[-1], shape, cfg, m)
        if local is None:
            spec = layer_pspec(names, shape, mesh,
                               head_dim=cfg.resolved_head_dim)
            sl = rank_slices(spec, shape, mesh,
                             {a: 0 for a in mesh.axis_names})
            local = [len(range(*s.indices(k))) for s, k in zip(sl, shape)]
        n = 1
        for k in local:
            n *= k
        total += n * itemsize
    return total


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


class _Recording:
    """The process group of a recording axis."""

    def __repr__(self) -> str:
        return "RECORDING"


RECORDING = _Recording()


def recording_axis(index: int, size: int) -> Axis:
    """Rank ``index``'s place on an axis of ``size`` ranks whose sums are
    recorded and not communicated (the dry run's stand-in for a group)."""
    return Axis(index, size, RECORDING)


# collective calls made by this process, by kind, and the host seconds
# spent in them; ``CALLS``: {(kind, group size, tensor bytes): calls}
# (``reset_counts`` zeroes all three)
_KINDS = ("reduce_model", "embed_lookup", "gather_vocab", "merge_exits",
          "gather_rows", "gather_heads", "sum_squares", "share_column")
COUNTS = dict.fromkeys(_KINDS, 0)
SECONDS = dict.fromkeys(_KINDS, 0.0)
CALLS: Dict[Tuple[str, int, int], int] = {}


def reset_counts() -> None:
    for k in _KINDS:
        COUNTS[k], SECONDS[k] = 0, 0.0
    CALLS.clear()


def records() -> List[Dict[str, Any]]:
    """``CALLS`` as records: {"kind", "op" (the HLO collective it is, an
    ``all-reduce`` for every call here), "group", "bytes" (the tensor's,
    each call), "count"}, in a fixed order."""
    return [{"kind": kind, "op": "all-reduce", "group": group,
             "bytes": nbytes, "count": n}
            for (kind, group, nbytes), n in sorted(CALLS.items())]


def _all_reduce(x: torch.Tensor, axis: Axis, kind: str) -> torch.Tensor:
    key = (kind, axis.size, x.numel() * x.element_size())
    CALLS[key] = CALLS.get(key, 0) + 1
    if axis.group is RECORDING:
        COUNTS[kind] += 1
        return x
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
                mx: torch.Tensor, axis: Optional[Axis], vocab_local: int):
    """Merge the exit heads of each rank's vocabulary slice: (conf, tok,
    lse, mx), each (E, B), of the local slice (``mx`` the exit kernel's
    raw max logit) -> (conf, tok, lse) of the whole vocabulary on every
    rank.  The ranks compare their raw max logits, as a single device
    compares its logits, the lowest rank winning a tie (its tokens come
    first); the token is that rank's argmax plus its offset; the global
    lse is the logsumexp of the ranks' lse; conf = exp(max - lse).  One
    sum over the group carries every rank's three numbers a row."""
    if not _live(axis):
        return conf, tok, lse
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


def gather_heads(x: torch.Tensor, axis: Optional[Axis], index: slice,
                 n: int, dim: int = -1) -> torch.Tensor:
    """A rank's entries ``index`` of a tensor whose dimension ``dim`` is
    ``n`` whole -> the whole tensor on every rank: a zero buffer, each
    rank writes its entries, the model group sums (exact).  Without a live
    axis, or with ``x`` whole already, it is ``x``."""
    dim %= x.dim()
    if not _live(axis) or x.shape[dim] == n:
        return x
    shape = list(x.shape)
    shape[dim] = n
    full = torch.zeros(shape, dtype=torch.float32, device=x.device)
    full[(slice(None),) * dim + (index,)] = x
    return _all_reduce(full, axis, "gather_heads").to(x.dtype)


def sum_squares(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The float32 sum of squares over the last dimension of ``x`` (keepdim),
    summed over the model group: a norm over a dimension the ranks split
    (each rank's partial sum, one sum over the group)."""
    ss = x.float().square().sum(-1, keepdim=True)
    if not _live(axis):
        return ss
    return _all_reduce(ss, axis, "sum_squares")


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


def share_column(x: torch.Tensor, axis: Optional[Axis],
                 owner: bool) -> torch.Tensor:
    """One data column's tensor on every rank of the data group: the
    owner column passes ``x``, every other column a tensor of the same
    shape and dtype whose values are ignored; a zero buffer and one sum in
    float32 (exact for float32, bf16, int8 and positions below 2**24)."""
    if not _live(axis):
        return x
    buf = (x.to(torch.float32, copy=True) if owner
           else torch.zeros(x.shape, dtype=torch.float32, device=x.device))
    return _all_reduce(buf, axis, "share_column").to(x.dtype)
