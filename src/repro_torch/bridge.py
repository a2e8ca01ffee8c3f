"""Carry weights from the JAX package's parameter pytree to the port.

The caller converts the pytree to numpy first (for example
``jax.tree.map(np.asarray, params)``); nothing here imports JAX.  The
result is a state dict for ``repro_torch.models.transformer.Model``: each
segment's stacked leading layer axis is unstacked into ``layers.<i>``,
projection weights keep their ``x @ W`` layout, and ``exit_norms`` stay
keyed by the exit layer's number as a string.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import build_segments

_TOP_LEVEL = {"embed", "segments", "final_norm", "lm_head", "exit_norms"}


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
        raise NotImplementedError(f"parameters {sorted(extra)} belong to "
                                  f"parts of the model not ported yet "
                                  f"(ROADMAP A.9)")
    state = {"embed": _tensor(np_params["embed"]),
             "final_norm": _tensor(np_params["final_norm"])}
    if "lm_head" in np_params:
        state["lm_head"] = _tensor(np_params["lm_head"])
    for layer, w in np_params["exit_norms"].items():
        state[f"exit_norms.{layer}"] = _tensor(w)
    for seg, tree in zip(build_segments(cfg), np_params["segments"]):
        for path, stacked in _leaves(tree):
            for j in range(seg.length):
                state[f"layers.{seg.start + j}.{path}"] = _tensor(stacked[j])
    return state
