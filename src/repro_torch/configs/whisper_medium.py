"""whisper-medium  [audio]
24L (enc) + 24L (dec) d_model=1024 16H (kv=16) d_ff=4096 vocab=51865 —
enc-dec; mel-spectrogram + conv frontend is a STUB per assignment
(input_specs provides 1500 precomputed frame embeddings).
[arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    n_layers=24,                   # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    qkv_bias=True,
    use_rope=False,                # sinusoidal absolute positions
    norm_type="layernorm",
    mlp_kind="gelu",
    encoder_layers=24,
    encoder_seq=1500,              # 30 s audio -> 1500 frames after conv stub
    exit_layers=(6, 12),
    source="arXiv:2212.04356",
).validate()
