"""Three-term roofline model (port of ``repro.roofline.analyze``), over the
H100 table of ``roofline.hw``:

    compute    = FLOPs       / (peak_FLOP/s)
    memory     = bytes       / HBM_bw
    collective = wire_bytes  / link_bw

per card, with MODEL_FLOPS = 6*N*D (training) / 2*N_active*D (inference) as
the useful-compute lower bound, and the decode KV traffic of a live cache
tree: every decoded token reads all mapped pages of its row across every
layer and writes one K/V row per layer.  The port's cache trees hold one
node a layer ({segment: [layer cache, ...]}), a paged node the dict with
``"kp"``, as the JAX package's; a stacked (L, P, ...) node counts all L.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.roofline import hw


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    model_flops: float            # 6*N_active*D global
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0

    model_compute_s: float = 0.0   # analytic 6ND-based lower bound

    def finish(self) -> "RooflineTerms":
        self.compute_s = self.flops_per_device / hw.PEAK_FLOPS_BF16
        self.memory_s = self.bytes_per_device / hw.HBM_BW
        self.collective_s = self.wire_bytes_per_device / hw.NVLINK_BW
        self.model_compute_s = (self.model_flops / self.chips
                                / hw.PEAK_FLOPS_BF16)
        terms = {"compute": max(self.compute_s, self.model_compute_s),
                 "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        total_flops = self.flops_per_device * self.chips
        self.useful_ratio = (self.model_flops / total_flops
                             if total_flops else 0.0)
        return self

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "compute_s": f"{self.compute_s:.3e}",
            "model_compute_s": f"{self.model_compute_s:.3e}",
            "memory_s": f"{self.memory_s:.3e}",
            "collective_s": f"{self.collective_s:.3e}",
            "bottleneck": self.bottleneck,
            "useful_ratio": f"{self.useful_ratio:.3f}",
        }


# ---------------------------------------------------------------------------
# Decode KV traffic of a live cache tree
# ---------------------------------------------------------------------------
def _paged_nodes(tree):
    """Yield every paged attention-cache node (dict with "kp") of a tree."""
    if isinstance(tree, dict):
        if "kp" in tree:
            yield tree
            return
        for v in tree.values():
            yield from _paged_nodes(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _paged_nodes(v)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def kv_page_bytes(tree) -> int:
    """Device bytes one decode token reads per mapped logical page: the
    page's slice of EVERY paged leaf (kp/vp, int8 scales, pos), summed
    across layers."""
    total = 0
    for node in _paged_nodes(tree):
        ax = 1 if node["kp"].dim() == 5 else 0
        for leaf in node.values():
            total += _nbytes(leaf) // leaf.shape[ax]
    return total


def kv_token_write_bytes(tree) -> int:
    """Device bytes one decode token writes: one K/V row (plus scales and
    a pos entry) per layer."""
    total = 0
    for node in _paged_nodes(tree):
        ax = 1 if node["kp"].dim() == 5 else 0
        for leaf in node.values():
            rows = leaf.shape[ax] * leaf.shape[ax + 1]   # pages x page_size
            total += _nbytes(leaf) // rows
    return total


def decode_kv_bytes_per_token(tree, ctx: int, page_size: int) -> int:
    """KV bytes per decoded token at context length ``ctx``: read all
    mapped pages + write one row, per layer."""
    pages = -(-int(ctx) // int(page_size))               # pages_needed
    return pages * kv_page_bytes(tree) + kv_token_write_bytes(tree)


def hbm_roofline_fraction(bytes_per_token: float, tokens_per_s: float
                          ) -> float:
    """Achieved KV-sweep bandwidth as a fraction of the card's HBM rate
    (``hw.HBM_BW``)."""
    return bytes_per_token * tokens_per_s / hw.HBM_BW


def count_params(cfg) -> float:
    """Total (rough) and active parameter counts for MODEL_FLOPS."""
    d, v, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    hd = cfg.resolved_head_dim
    attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
    total = active = v * d  # embedding
    for k in cfg.block_kinds():
        if k in ("dense", "shared_attn"):
            mlp = d * cfg.d_ff * (2 if cfg.mlp_kind == "gelu" else 3)
            total += attn + mlp
            active += attn + mlp
        elif k == "moe":
            e = cfg.moe.num_experts
            per = d * cfg.moe.expert_d_ff * 3
            total += attn + e * per
            active += attn + cfg.moe.top_k * per
        elif k == "mlstm":
            di = d * (cfg.ssm.expand if cfg.ssm else 2)
            blk = d * 2 * di + 3 * di * di + di * d
            total += blk
            active += blk
        elif k == "slstm":
            blk = 8 * d * d + d * int(d * 4 / 3) * 3
            total += blk
            active += blk
        elif k == "mamba2":
            di = d * cfg.ssm.expand
            n = cfg.ssm.state_size
            blk = d * (2 * di + 2 * n + di // 64) + di * d
            total += blk
            active += blk
    if cfg.is_encdec:
        mlp = d * cfg.d_ff * 2
        total += cfg.encoder_layers * (attn + mlp) + L * attn  # cross attn
        active += cfg.encoder_layers * (attn + mlp) + L * attn
    return total, active


def model_flops(cfg, shape) -> float:
    """6*N_active*D for training; 2*N_active*D per generated/processed
    token for inference (``shape`` a ``configs.shapes.InputShape``)."""
    _, active = count_params(cfg)
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6 if shape.kind == "train" else 2
    return mult * active * tokens


def analyze(record: Dict, cfg, shape) -> Optional[RooflineTerms]:
    """record: one dry-run entry ({"arch", "shape", "mesh", "n_devices",
    "cost_analysis": {"flops", "bytes accessed"}, "collectives": {kind:
    {"wire_bytes"}}})."""
    cost = record.get("cost_analysis") or {}
    coll = record.get("collectives") or {}
    wire = sum(v.get("wire_bytes", 0.0) for v in coll.values())
    return RooflineTerms(
        arch=record["arch"], shape=record["shape"], mesh=record["mesh"],
        chips=record["n_devices"],
        flops_per_device=float(cost.get("flops", 0.0)),
        bytes_per_device=float(cost.get("bytes accessed", 0.0)),
        wire_bytes_per_device=wire,
        model_flops=model_flops(cfg, shape),
    ).finish()
