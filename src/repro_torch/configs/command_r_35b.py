"""command-r-35b  [dense]
40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000 — GQA, no bias.
[hf:CohereForAI/c4ai-command-r-v01]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    arch_type="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    qkv_bias=False,
    rope_theta=8000000.0,
    tie_embeddings=True,
    exit_layers=(10, 20),
    source="hf:CohereForAI/c4ai-command-r-v01",
).validate()
