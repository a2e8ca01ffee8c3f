"""granite-moe-3b-a800m  [moe]
32L d_model=1536 24H (GQA kv=8) per-expert d_ff=512 vocab=49155,
MoE 40 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base family]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,                      # per-expert ffn width
    vocab_size=49155,
    qkv_bias=False,
    tie_embeddings=True,
    moe=MoEConfig(num_experts=40, top_k=8, expert_d_ff=512),
    exit_layers=(8, 16),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
).validate()
