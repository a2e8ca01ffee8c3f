"""gemma3-12b  [dense]
48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144 — 5:1 local:global
sliding-window attention (window 1024), 128k context.  [hf:google/gemma-3-1b-pt]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    arch_type="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    rope_theta=1000000.0,
    sliding_window=1024,
    local_global_pattern=5,        # 5 local layers then 1 global layer
    tie_embeddings=True,
    exit_layers=(12, 24),
    source="hf:google/gemma-3-1b-pt",
).validate()
