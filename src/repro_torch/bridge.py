"""Carry weights between the JAX package's parameter pytree and the port.

The caller converts the pytree to numpy first (for example
``jax.tree.map(np.asarray, params)``); nothing here imports JAX.  The
result is a state dict for ``repro_torch.models.transformer.Model``: each
segment's stacked leading layer axis is unstacked into ``layers.<i>``,
projection weights keep their ``x @ W`` layout, and ``exit_norms`` stay
keyed by the exit layer's number as a string.  Layer norms carry their
``*_scale`` and ``*_bias`` leaves, and a dict-valued ``final_norm``
becomes ``final_norm.scale`` and ``.bias``.  An encoder-decoder's stacked
``encoder.layers`` unstack into ``encoder.layers.<i>`` beside
``encoder.norm``, and each decoder block's ``cross.*`` (with its biases)
carries like ``attn.*``; a vision prefix brings ``vis_proj``.  A MoE
block's leaves (``moe.router``, ``moe.w_gate``, ``moe.w_up``,
``moe.w_down``) carry across like the others; the router stays float32 in
a model of any dtype, as the port's ``MoE`` module holds it.  The recurrent blocks' leaves
(mLSTM, sLSTM, Mamba2) unstack the same way, Mamba2's float32 ``a_log``,
``dt_bias`` and ``d_skip`` staying float32.  Zamba2's shared attention
block (``params["shared"]``) becomes ``shared.*``; its segments' empty
``{}`` placeholders carry nothing.

``params_to_jax`` is the inverse: the port's parameters as the JAX
package's pytree of numpy arrays (segments stacked on their leading layer
axis again, Zamba2's shared segments as ``{}``).  ``jax_layout`` alone
states the layout: the pytree's skeleton, whose leaves are the port's
tensors (a ``Stacked`` run of them for a leaf with a layer axis).  Both
directions, and the JAX-format checkpoints of
``repro_torch.training.checkpoint``, walk it with ``flatten`` and
``treedef_str`` in ``jax.tree.flatten``'s order (dict keys sorted, tuples
in order, an empty dict no leaf), ``treedef_str`` printing its
``str(jax.tree.structure(...))``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.sharding import Axis
from repro_torch.models.transformer import Model


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)                               # writable copy
    if a.dtype.name == "bfloat16":                # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


# ---------------------------------------------------------------------------
# the port -> the JAX package's pytree
# ---------------------------------------------------------------------------
class Stacked(tuple):
    """A leaf of the JAX pytree that stacks one tensor a layer (a
    segment's or the encoder's leading layer axis)."""


Leaf = Union[torch.Tensor, Stacked]


def _nest(tree: Dict[str, Any], path: str, leaf: Leaf) -> None:
    *keys, last = path.split(".")
    for key in keys:
        tree = tree.setdefault(key, {})
    tree[last] = leaf


def _block_tree(blocks: Sequence[nn.Module], stacked: bool) -> Dict:
    """The pytree of one block (``stacked=False``) or of a run of blocks
    of one kind stacked on a leading layer axis."""
    tree: Dict[str, Any] = {}
    for name, w in blocks[0].named_parameters():
        _nest(tree, name, Stacked(b.get_parameter(name) for b in blocks)
              if stacked else w)
    return tree


def _norm_tree(norm) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
    if isinstance(norm, nn.ParameterDict):
        return dict(norm.items())
    return norm


def jax_layout(model: nn.Module) -> Dict[str, Any]:
    """The JAX package's parameter pytree for ``model`` (a
    ``repro_torch.models.transformer.Model``), each leaf the port's
    parameter or a ``Stacked`` run of them; nothing is copied.  A tier
    model (one partition) has no such pytree and raises."""
    if getattr(model, "tier", None) is not None:
        raise ValueError(f"the {model.tier} tier holds one partition, not "
                         f"the JAX package's pytree")
    cfg = model.cfg
    segments: List[Dict] = []
    for seg in model.segments:
        segments.append({} if seg.shared else _block_tree(
            [model.layers[seg.start + j] for j in range(seg.length)], True))
    tree: Dict[str, Any] = {"embed": model.embed,
                            "segments": tuple(segments),
                            "final_norm": _norm_tree(model.final_norm),
                            "exit_norms": dict(model.exit_norms.items())}
    if hasattr(model, "shared"):
        tree["shared"] = _block_tree([model.shared], False)
    if not cfg.tie_embeddings:
        tree["lm_head"] = model.lm_head
    if cfg.is_encdec:
        tree["encoder"] = {
            "layers": _block_tree(list(model.encoder.layers), True),
            "norm": _norm_tree(model.encoder.norm)}
    if cfg.vision_tokens:
        tree["vis_proj"] = model.vis_proj
    return tree


def flatten(tree: Any) -> List[Any]:
    """The leaves in ``jax.tree.flatten``'s order: dict keys sorted, tuples
    in order; an empty dict has none."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in flatten(tree[key])]
    if isinstance(tree, tuple) and not isinstance(tree, Stacked):
        return [leaf for sub in tree for leaf in flatten(sub)]
    return [tree]


def _structure(tree: Any) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{key!r}: {_structure(tree[key])}"
                               for key in sorted(tree)) + "}"
    if isinstance(tree, tuple) and not isinstance(tree, Stacked):
        inner = ", ".join(_structure(sub) for sub in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "*"


def treedef_str(tree: Any) -> str:
    """``str(jax.tree.structure(tree))`` of a pytree of dicts, tuples and
    leaves."""
    return f"PyTreeDef({_structure(tree)})"


def param_leaves(cfg: ModelConfig, itemsize: int = 4):
    """(path names, shape, itemsize) of every leaf of ``cfg``'s JAX
    pytree, stacked segments included, in ``flatten``'s order: what
    ``launch.sharding.estimate_param_bytes_per_device`` takes.  Float32
    leaves (MoE routers, Mamba2's) keep 4 bytes; the rest ``itemsize``."""
    model = Model(cfg, device="meta")
    out = []

    def walk(tree, path):
        if isinstance(tree, dict):
            for key in sorted(tree):
                walk(tree[key], path + (str(key),))
        elif isinstance(tree, tuple) and not isinstance(tree, Stacked):
            for i, sub in enumerate(tree):
                walk(sub, path + (str(i),))
        else:
            first = tree[0] if isinstance(tree, Stacked) else tree
            shape = (((len(tree),) if isinstance(tree, Stacked) else ())
                     + tuple(first.shape))
            size = 4 if path[-1] in ("router", "a_log", "dt_bias",
                                     "d_skip") else itemsize
            out.append((path, shape, size))
    walk(jax_layout(model), ())
    return out


def port_leaves(cfg: ModelConfig, itemsize: int = 4):
    """(the port's parameter name split at dots, whole shape, itemsize,
    block kind or None) of every parameter of ``cfg``'s single-device
    model: what ``launch.sharding.rank_param_bytes`` takes.  The leaves
    that a bf16 model keeps in float32 keep 4 bytes, as ``param_leaves``."""
    kinds = cfg.block_kinds()
    meta = Model(cfg, device="meta", dtype=torch.bfloat16)
    for name, p in meta.named_parameters():
        names = tuple(name.split("."))
        kind = kinds[int(names[1])] if names[0] == "layers" else None
        size = 4 if p.dtype == torch.float32 else itemsize
        yield names, tuple(p.shape), size, kind


def to_numpy(leaf: Leaf) -> np.ndarray:
    """One leaf as the JAX package holds it: a parameter, or a ``Stacked``
    run on a leading layer axis (stacked on the parameters' device, then
    copied once).  bfloat16 (which numpy lacks) becomes float32."""
    t = (torch.stack([w.detach() for w in leaf])
         if isinstance(leaf, Stacked) else leaf.detach())
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def map_leaves(tree: Any, fn) -> Any:
    """``tree`` with ``fn`` applied to every leaf (a ``Stacked`` run is one
    leaf)."""
    if isinstance(tree, dict):
        return {k: map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and not isinstance(tree, Stacked):
        return tuple(map_leaves(v, fn) for v in tree)
    return fn(tree)


def check_config(model: nn.Module, cfg: Optional[ModelConfig]) -> None:
    """Raise unless ``cfg`` is None or ``model``'s configuration."""
    if cfg is not None and cfg != model.cfg:
        raise ValueError(f"the model is {model.cfg.name}, not {cfg.name}")


def params_to_jax(model: nn.Module, cfg: Optional[ModelConfig] = None
                  ) -> Dict[str, Any]:
    """The port's parameters -> the JAX package's params as numpy arrays
    (the inverse of ``params_from_jax``); ``cfg``, when given, must be the
    model's."""
    check_config(model, cfg)
    return map_leaves(jax_layout(model), to_numpy)


def params_from_jax(np_params: Dict[str, Any], cfg: ModelConfig, *,
                    mesh=None, rank: int = 0,
                    tier: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """JAX params as numpy arrays -> the port's state dict (CPU tensors in
    the leaves' dtypes), leaf by leaf along ``jax_layout`` of a ``cfg``
    model on the meta device.  Raises unless the pytree and every leaf's
    shape are that model's.  With ``mesh`` (a ``(data, model)`` pair) the
    state dict of rank ``rank``'s share, for ``Model(cfg, axis=)`` at that
    rank's model index: each leaf sliced in numpy, so no whole tensor is
    made.  With ``tier`` (``"edge"`` or ``"cloud"``) the state dict of
    ``Model(cfg, tier=)``: only the leaves, and the layers of a stacked
    leaf, that the tier holds."""
    model = Model(cfg, device="meta")
    keep = None
    if tier is not None:
        keep = {n for n, _ in Model(cfg, device="meta",
                                    tier=tier).named_parameters()}
    layout = jax_layout(model)
    if treedef_str(np_params) != treedef_str(layout):
        raise ValueError(f"the parameters are not {cfg.name}'s pytree")
    names = {id(p): n for n, p in model.named_parameters()}
    shards = {}
    if mesh is not None:
        m = int(mesh[1])
        shards = Model(cfg, device="meta",
                       axis=Axis(rank % m, m)).shards
    state = {}
    for leaf, value in zip(flatten(layout), flatten(np_params)):
        stacked = isinstance(leaf, Stacked)
        targets, values = (leaf, value) if stacked else ((leaf,), (value,))
        shape = ((len(leaf),) if stacked else ()) + tuple(targets[0].shape)
        if tuple(value.shape) != shape:
            raise ValueError(f"{names[id(targets[0])]}: a leaf of shape "
                             f"{tuple(value.shape)} for {shape}")
        for t, v in zip(targets, values):
            name = names[id(t)]
            if keep is not None and name not in keep:
                continue
            if name in shards:
                v = np.asarray(v)[shards[name][1]]
            state[name] = _tensor(v)
    return state


def rank_cutter(model: nn.Module) -> Callable[[Leaf, np.ndarray],
                                               np.ndarray]:
    """``cut(leaf, value)``: the part of a whole JAX leaf ``value`` that
    ``leaf`` of ``model`` holds, for a sharded ``Model`` (a cloud-mesh
    rank's share) its slice, else ``value`` itself.  Build it once a
    load: it maps the model's parameters to their names."""
    shards = getattr(model, "shards", None) or {}
    names = {id(p): n for n, p in model.named_parameters()} if shards else {}

    def cut(leaf: Leaf, value: np.ndarray) -> np.ndarray:
        first = leaf[0] if isinstance(leaf, Stacked) else leaf
        name = names.get(id(first))
        if name not in shards:
            return value
        sl = shards[name][1]
        return value[((slice(None),) + sl) if isinstance(leaf, Stacked)
                     else sl]
    return cut


@torch.no_grad()
def load_leaf(leaf: Leaf, value: np.ndarray) -> None:
    """Copy one JAX leaf into the port's tensors, cast to each tensor's
    dtype (a ``Stacked`` leaf unstacks along its layer axis)."""
    targets = leaf if isinstance(leaf, Stacked) else (leaf,)
    values = value if isinstance(leaf, Stacked) else (value,)
    if len(values) != len(targets):
        raise ValueError(f"a leaf of {len(values)} layers for "
                         f"{len(targets)}")
    for t, v in zip(targets, values):
        # numpy has no bfloat16: ml_dtypes' arrives as another type
        src = _tensor(v) if v.dtype.name == "bfloat16" else torch.as_tensor(v)
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"leaf of shape {tuple(src.shape)} for a "
                             f"parameter of shape {tuple(t.shape)}")
        t.copy_(src)
