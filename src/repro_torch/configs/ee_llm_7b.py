"""ee-llm-7b — the paper's own model (EE-LLM 7B, architecturally
LLaMA2-7B with early exits at layers 8 and 16 of 32).
[CE-CoLLM §5; EE-LLM arXiv:2312.04916; llama2 arXiv:2307.09288]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="ee-llm-7b",
    arch_type="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=32000,
    exit_layers=(8, 16),           # l_ee1=8, l_ee2=16 (edge partition = 1..16)
    source="CE-CoLLM (Jin & Wu 2024) / EE-LLM 7B",
).validate()
