"""Mixtral-8x7B — MoE 8 experts top-2 with sliding-window attention. [arXiv:2401.04088]"""
from repro_torch.config import ModelConfig, uniform

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=uniform("swa", 32),
    mlp_kind="moe",
    n_experts=8,
    experts_per_token=2,
    moe_d_ff=14336,
    window=4096,
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088",
)
