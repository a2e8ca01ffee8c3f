"""zamba2-1.2b  [hybrid]
38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64 —
Mamba2 backbone + shared attention blocks (one shared transformer block
applied periodically).  [arXiv:2411.15242]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,                     # shared attn block ffn width
    vocab_size=32000,
    ssm=SSMConfig(state_size=64, conv_width=4, expand=2, chunk_size=256),
    hybrid_attn_period=6,
    exit_layers=(10, 19),
    source="arXiv:2411.15242",
).validate()
