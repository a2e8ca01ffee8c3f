"""xlstm-350m  [ssm]
24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304 — sLSTM + mLSTM blocks.
[arXiv:2405.04517]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    arch_type="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,                         # xLSTM blocks carry their own projections
    vocab_size=50304,
    tie_embeddings=True,
    ssm=SSMConfig(state_size=0, conv_width=4, expand=2, chunk_size=256,
                  num_ssm_heads=4),
    exit_layers=(6, 12),
    source="arXiv:2405.04517",
).validate()
