"""Input specs and step functions of every (architecture x input shape)
combination, on records and tensors without storage (port of
``repro.launch.specs``).  Nothing allocates.

The JAX package describes a step's arguments as ``ShapeDtypeStruct``
pytrees and hands them to ``jax.jit(...).lower``; the port describes
them as ``Leaf`` records (a leaf's path in the JAX package's pytree, its
shape and dtype), so that the bytes each device holds under the sharding
rules of ``launch/sharding.py`` are the JAX package's to the byte:

  * ``input_specs(cfg, shape)``: train (params, the AdamW state, the
    batch), prefill (params, the batch, caches), decode (params, the
    token, caches, pos), in the JAX package's dtypes: bf16 parameters
    (the leaves JAX keeps in float32 stay float32), float32 moments, an
    int32 step count, caches in bf16 as the JAX model's compute dtype;
  * ``choose_fsdp``: FSDP when a device would hold more than 2 GiB of
    parameters without it;
  * ``arg_shardings``: each argument leaf's spec on a ``MeshShape`` of
    ``(16, 16)`` ``("data", "model")`` or ``(2, 16, 16)`` ``("pod",
    "data", "model")``; ``arg_bytes_per_device`` their bytes a device;
  * ``make_step_fn(model, kind)``: the port's train step, the prefill
    step and the serve step with every exit's confidence, run by
    ``launch/dryrun.py`` on tensors without storage (``FakeTensorMode``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.bridge import param_leaves
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import sharding as shardlib
from repro_torch.models.transformer import Model

FSDP_THRESHOLD = 2 << 30        # bytes of parameters a device, without FSDP


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One argument leaf: its path in the JAX package's pytree, its shape
    and its dtype (the ``ShapeDtypeStruct`` of the JAX package)."""
    names: Tuple[str, ...]
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def itemsize(self) -> int:
        return torch.empty((), dtype=self.dtype, device="meta").element_size()

    @property
    def nbytes(self) -> int:
        n = self.itemsize
        for d in self.shape:
            n *= d
        return n


Args = Tuple[List[Leaf], ...]


# --------------------------------------------------------------------------
# input specs
# --------------------------------------------------------------------------
def batch_input_specs(cfg: ModelConfig, shape: InputShape, *,
                      with_labels: bool,
                      dtype=torch.bfloat16) -> List[Leaf]:
    b, s = shape.global_batch, shape.seq_len
    specs = [Leaf(("tokens",), (b, s), torch.int32)]
    if with_labels:
        specs += [Leaf(("labels",), (b, s), torch.int32),
                  Leaf(("mask",), (b, s), dtype)]
    if cfg.is_encdec:
        specs.append(Leaf(("frames",), (b, cfg.encoder_seq, cfg.d_model),
                          dtype))
    if cfg.vision_tokens:
        specs.append(Leaf(("patches",), (b, cfg.vision_tokens, cfg.d_model),
                          dtype))
    return sorted(specs, key=lambda leaf: leaf.names)   # JAX's dict order


def param_specs(cfg: ModelConfig) -> List[Leaf]:
    """The JAX package's bf16 parameter pytree (``build_model(cfg,
    param_dtype=bfloat16).param_specs()``) as leaves."""
    return [Leaf(tuple(names), tuple(shp),
                 torch.float32 if size == 4 else torch.bfloat16)
            for names, shp, size in param_leaves(cfg, itemsize=2)]


def adamw_specs(params: List[Leaf]) -> List[Leaf]:
    """The JAX package's ``init_adamw`` state: the step count, then two
    float32 moments of every parameter."""
    return ([Leaf(("step",), (), torch.int32)]
            + [Leaf(("mu",) + p.names, p.shape, torch.float32)
               for p in params]
            + [Leaf(("nu",) + p.names, p.shape, torch.float32)
               for p in params])


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int,
                dtype=torch.bfloat16) -> List[Leaf]:
    """The JAX package's dense caches (``Model.cache_specs``): each
    segment's per-layer leaves stacked on a leading layer axis (a shared
    block's once, unstacked), from the port's caches on the meta device."""
    model = Model(cfg, device="meta", dtype=dtype)
    caches = model.init_cache(batch, max_seq)
    out: List[Leaf] = []

    def walk(node, path, lead):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], path + (str(key),), lead)
        else:
            out.append(Leaf(path, lead + tuple(node.shape), node.dtype))
    for si in sorted(caches):
        seg = model.segments[si]
        layers = caches[si]
        walk(layers[0], (str(si),), () if seg.shared else (len(layers),))
    return out


def input_specs(cfg: ModelConfig, shape: InputShape) -> Args:
    """All arguments of the shape's step, as ``Leaf`` lists."""
    b, s = shape.global_batch, shape.seq_len
    params = param_specs(cfg)
    if shape.kind == "train":
        return (params, adamw_specs(params),
                batch_input_specs(cfg, shape, with_labels=True))
    if shape.kind == "prefill":
        return (params, batch_input_specs(cfg, shape, with_labels=False),
                cache_specs(cfg, b, s))
    return (params, [Leaf(("token",), (b, 1), torch.int32)],
            cache_specs(cfg, b, s), [Leaf(("pos",), (), torch.int32)])


# --------------------------------------------------------------------------
# shardings
# --------------------------------------------------------------------------
def _leaves3(leaves: List[Leaf]):
    return [(p.names, p.shape, p.itemsize) for p in leaves]


def choose_fsdp(params: List[Leaf], mesh,
                threshold_bytes: int = FSDP_THRESHOLD) -> bool:
    per_dev = shardlib.estimate_param_bytes_per_device(_leaves3(params),
                                                       mesh, fsdp=False)
    return per_dev > threshold_bytes


def arg_shardings(shape: InputShape, mesh, args: Args,
                  fsdp: bool = None) -> Tuple[List[tuple], ...]:
    """Each argument leaf's spec (``PartitionSpec`` order), argument by
    argument, as the JAX package's ``arg_shardings`` gives them:
    parameters and moments by ``param_pspec`` (FSDP as chosen), caches by
    ``cache_pspec``, the batch and the token by ``input_pspec``, the step
    count and ``pos`` replicated."""
    b = shape.global_batch
    if fsdp is None:
        fsdp = choose_fsdp(args[0], mesh)

    def params_of(leaves):
        return [shardlib.param_pspec(p.names, p.shape, mesh, fsdp=fsdp)
                for p in leaves]

    def batch_of(leaves):
        return [shardlib.input_pspec(p.shape, mesh, b) for p in leaves]

    def caches_of(leaves):
        return [shardlib.cache_pspec(p.names, p.shape, mesh, batch=b)
                for p in leaves]

    psh = params_of(args[0])
    if shape.kind == "train":
        opt = args[1]
        osh = [() if p.names == ("step",) else
               shardlib.param_pspec(p.names[1:], p.shape, mesh, fsdp=fsdp)
               for p in opt]
        return (psh, osh, batch_of(args[2]))
    if shape.kind == "prefill":
        return (psh, batch_of(args[1]), caches_of(args[2]))
    return (psh, batch_of(args[1]), caches_of(args[2]), [()])


def shard_bytes(leaf: Leaf, spec: tuple, mesh) -> int:
    """Bytes of one device's shard of ``leaf`` under ``spec``."""
    parts = 1
    for s in spec:
        if s:
            parts *= shardlib._axis_size(mesh, s)
    return leaf.nbytes // parts


def arg_bytes_per_device(args: Args, shardings, mesh) -> int:
    """Per-device resident argument bytes (params, moments, caches,
    inputs) under ``shardings``: the JAX dry run's
    ``arg_bytes_per_device``."""
    return int(sum(shard_bytes(leaf, spec, mesh)
                   for leaves, specs in zip(args, shardings)
                   for leaf, spec in zip(leaves, specs)))


# --------------------------------------------------------------------------
# step functions
# --------------------------------------------------------------------------
def make_step_fn(model: Model, kind: str, microbatches: int = 1) -> Callable:
    """The step of ``kind`` on ``model``: ``train`` is
    ``training.train_step.make_train_step`` (called with ``(opt,
    batch)``), ``prefill`` takes ``(batch, caches)`` and returns (the
    greedy token of the last position, caches), ``decode`` takes ``(token,
    caches, pos)`` and returns (the greedy token, every exit's
    confidence, caches)."""
    if kind == "train":
        from repro_torch.training.optim import AdamWConfig
        from repro_torch.training.train_step import make_train_step
        return make_train_step(model, AdamWConfig(),
                               microbatches=microbatches)
    if kind == "prefill":
        def prefill_step(batch: Dict[str, torch.Tensor], caches):
            x, _, caches, _ = model.prefill(batch, caches)
            logits = model.logits(x[:, -1:])[:, 0]
            return logits.argmax(-1).to(torch.int32), caches
        return prefill_step

    def serve_step(token: torch.Tensor, caches, pos):
        x, exit_h, caches = model.decode_step(token, caches, pos)
        logits = model.logits(x)[:, 0]
        confs = {}
        for layer, h in exit_h.items():
            xl = model.exit_logits(layer, h)[:, 0].float()
            confs[layer] = torch.exp(xl.max(-1).values
                                     - torch.logsumexp(xl, -1))
        return logits.argmax(-1).to(torch.int32), confs, caches
    return serve_step
