"""Architecture registry: ``--arch <id>`` resolution.

The port serves the paper's ee-llm-7b, the JAX package's four dense
decoders, its two mixture-of-experts decoders (olmoe-1b-7b,
granite-moe-3b-a800m), its recurrent and hybrid decoders (xlstm-350m,
zamba2-1.2b), the encoder-decoder whisper-medium and the vision-prefix
paligemma-3b.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (command_r_35b, ee_llm_7b, gemma3_12b,
                                 granite_moe_3b_a800m, olmoe_1b_7b,
                                 paligemma_3b, qwen1_5_110b, stablelm_12b,
                                 whisper_medium, xlstm_350m, zamba2_1_2b)
from repro_torch.configs.base import ModelConfig, reduced

_MODULES = (qwen1_5_110b, gemma3_12b, command_r_35b, stablelm_12b,
            olmoe_1b_7b, granite_moe_3b_a800m, xlstm_350m, zamba2_1_2b,
            whisper_medium, paligemma_3b, ee_llm_7b)

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
# the assigned architectures (every one but the paper's ee-llm-7b), in
# the JAX package's order: what ``launch/dryrun.py --all`` runs
ASSIGNED = ("granite-moe-3b-a800m", "qwen1.5-110b", "xlstm-350m",
            "olmoe-1b-7b", "gemma3-12b", "paligemma-3b", "command-r-35b",
            "zamba2-1.2b", "whisper-medium", "stablelm-12b")


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def get_smoke_config(arch: str) -> ModelConfig:
    return reduced(get_config(arch))
