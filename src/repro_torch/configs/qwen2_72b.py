"""Qwen2-72B — dense GQA with QKV bias. [arXiv:2407.10671]"""
from repro_torch.config import ModelConfig, uniform

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    block_pattern=uniform("attn", 80),
    mlp_kind="dense",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="arXiv:2407.10671",
)
