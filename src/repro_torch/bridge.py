"""Carry weights from the JAX package's parameter pytree to the port.

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
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import build_segments

_TOP_LEVEL = {"embed", "segments", "shared", "final_norm", "lm_head",
              "exit_norms", "encoder", "vis_proj"}


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)                               # writable copy
    if a.dtype.name == "bfloat16":                # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, f"{prefix}{key}.")
    else:
        yield prefix[:-1], tree


def params_from_jax(np_params: Dict[str, Any],
                    cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """JAX params as numpy arrays -> the port's state dict (CPU tensors)."""
    extra = set(np_params) - _TOP_LEVEL
    if extra:
        raise ValueError(f"parameters {sorted(extra)} have no place in the "
                         f"port's model")
    state = {"embed": _tensor(np_params["embed"])}
    for key in ("final_norm", "vis_proj", "lm_head"):
        for path, w in _leaves(np_params.get(key, {}), f"{key}."):
            state[path] = _tensor(w)
    encoder = np_params.get("encoder", {})
    for path, w in _leaves(encoder.get("norm", {}), "encoder.norm."):
        state[path] = _tensor(w)
    for path, stacked in _leaves(encoder.get("layers", {})):
        for j in range(stacked.shape[0]):
            state[f"encoder.layers.{j}.{path}"] = _tensor(stacked[j])
    for layer, w in np_params["exit_norms"].items():
        state[f"exit_norms.{layer}"] = _tensor(w)
    for path, w in _leaves(np_params.get("shared", {})):
        state[f"shared.{path}"] = _tensor(w)
    for seg, tree in zip(build_segments(cfg), np_params["segments"]):
        if seg.shared:
            continue                      # an alias of params["shared"]
        for path, stacked in _leaves(tree):
            for j in range(seg.length):
                state[f"layers.{seg.start + j}.{path}"] = _tensor(stacked[j])
    return state
