"""Architecture registry: ``--arch <id>`` resolution.

The port serves the dense early-exit decoder; the JAX package's other ten
architectures are still to be ported (ROADMAP A.9).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import ee_llm_7b
from repro_torch.configs.base import ModelConfig, reduced

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in (ee_llm_7b,)}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def get_smoke_config(arch: str) -> ModelConfig:
    return reduced(get_config(arch))
