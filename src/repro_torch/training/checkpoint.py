"""Checkpoints in the JAX package's format (``repro.training.checkpoint``).

A checkpoint at ``path`` is two files:

* ``<path>.npz``: the parameter pytree's leaves as ``leaf_0`` ..
  ``leaf_{n-1}`` in ``jax.tree.flatten`` order (dict keys sorted, tuples
  in order, an empty dict no leaf), each in the JAX package's layout
  (segments stacked on their leading layer axis);
* ``<path>.json``: ``{"n_leaves": n, "treedef": str(treedef), "extra":
  {...}}``.

So a checkpoint the JAX package writes loads into the port, and one the
port writes loads into the JAX package's ``load_checkpoint``.  Leaves are
written and read one at a time (a whole float32 ee-llm-7b is 15.6 GB on
the host otherwise); loading casts each to its parameter's dtype.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Dict, Optional

import numpy as np
from torch import nn

from repro_torch.bridge import (check_config, flatten, jax_layout,
                                load_leaf, rank_cutter, to_numpy, treedef_str)
from repro_torch.configs.base import ModelConfig


def save_checkpoint(path: str, model: nn.Module,
                    cfg: Optional[ModelConfig] = None,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Write ``model``'s parameters to ``<path>.npz`` and the manifest to
    ``<path>.json`` (bfloat16 leaves as float32: numpy has no bfloat16).
    Refuses a cloud-mesh rank's share: its leaves are slices of the
    whole model's."""
    check_config(model, cfg)
    if getattr(model, "shards", None):
        raise ValueError("save_checkpoint: the model is a cloud-mesh rank's "
                         "share; save the whole model")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    layout = jax_layout(model)
    leaves = flatten(layout)
    # np.savez's layout (a zip of leaf_i.npy members, stored), one leaf at
    # a time
    with zipfile.ZipFile(path + ".npz", "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, leaf in enumerate(leaves):
            a = np.ascontiguousarray(to_numpy(leaf))
            with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                # write_array's header, then the data without its copies
                np.lib.format.write_array_header_1_0(
                    f, np.lib.format.header_data_from_array_1_0(a))
                f.write(memoryview(a).cast("B"))
    manifest = {"n_leaves": len(leaves), "treedef": treedef_str(layout),
                "extra": extra or {}}
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)


def load_checkpoint(path: str, model: nn.Module,
                    cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """Read ``<path>`` into ``model``'s parameters in place (a cloud-mesh
    rank's share takes its slice of each leaf); returns the manifest's
    ``extra``.  Raises when the checkpoint's pytree is not the model's."""
    check_config(model, cfg)
    layout = jax_layout(model)
    leaves = flatten(layout)
    with open(path + ".json") as f:
        manifest = json.load(f)
    if manifest["treedef"] != treedef_str(layout):
        raise ValueError(f"{path}: the checkpoint's pytree is not "
                         f"{model.cfg.name}'s")
    with np.load(path + ".npz") as data:
        if len(data.files) != len(leaves):
            raise ValueError(f"checkpoint has {len(data.files)} leaves, "
                             f"the model has {len(leaves)}")
        cut = rank_cutter(model)
        for i, leaf in enumerate(leaves):
            load_leaf(leaf, cut(leaf, data[f"leaf_{i}"]))
    return manifest.get("extra", {})
