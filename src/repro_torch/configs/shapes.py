"""Assigned input shapes and the (arch x shape) run matrix rules (a copy of
``repro.configs.shapes``: ``roofline.analyze.model_flops`` takes them)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

SHAPES: Tuple[InputShape, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg, shape: InputShape) -> Tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic decode archs."""
    if shape.name == "long_500k":
        if cfg.supports_long_decode:
            return True, ""
        return False, (
            f"{cfg.name} is a pure full-attention decoder; long_500k requires "
            "sub-quadratic attention (skip documented in DESIGN.md)")
    return True, ""
