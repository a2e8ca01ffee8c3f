"""paligemma-3b  [vlm]
18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216 — SigLIP vision
frontend (STUB per assignment: input_specs provides patch embeddings) +
gemma decoder.  [arXiv:2407.07726]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    arch_type="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    tie_embeddings=True,
    vision_tokens=256,             # SigLIP 224px/14 -> 256 patch embeddings
    exit_layers=(5, 9),
    source="arXiv:2407.07726",
).validate()
