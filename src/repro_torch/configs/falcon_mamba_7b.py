"""Falcon-Mamba-7B — pure Mamba1 SSM, attention-free. [arXiv:2410.05355]"""
from repro_torch.config import ModelConfig, uniform

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=65024,
    block_pattern=uniform("mamba1", 64),
    mlp_kind="none",
    ssm_state=16,
    d_inner=8192,
    conv_width=4,
    source="arXiv:2410.05355",
)
