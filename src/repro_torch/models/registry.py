"""Model construction entry point."""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.sharding import Axis
from repro_torch.models.transformer import Model


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA is
    asked for (explicitly or by default) and absent — the port never
    carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def build_model(cfg: ModelConfig, *, device=None, dtype=torch.float32,
                seed: int = 0, axis: Optional[Axis] = None) -> Model:
    """Allocate ``cfg`` on ``device`` (default ``cuda``) in ``dtype`` and
    initialise it from a ``torch.Generator`` seeded with ``seed``; under a
    cloud-mesh rank's model ``axis``, that rank's share of the same
    weights."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return Model(cfg, device=dev, dtype=dtype, axis=axis).init(gen)
