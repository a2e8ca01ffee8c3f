"""olmoe-1b-7b  [moe]
16L d_model=2048 16H (GQA kv=16) per-expert d_ff=1024 vocab=50304,
MoE 64 experts top-8.  [arXiv:2409.02060]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    arch_type="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    moe=MoEConfig(num_experts=64, top_k=8, expert_d_ff=1024),
    exit_layers=(4, 8),
    source="arXiv:2409.02060",
).validate()
