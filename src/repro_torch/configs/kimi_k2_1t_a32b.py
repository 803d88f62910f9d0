"""Kimi K2 — trillion-param MoE, 384 experts top-8. [arXiv:2501.kimi2]

61 layers, d_model 7168, 64 heads (GQA, 8 KV heads), per-expert d_ff
2048, vocab 163840.  The paper's head_dim is 112 (7168 / 64); the config
keeps 128, as the reference does (the projection shapes absorb the
difference).
"""
from repro_torch.config import ModelConfig, uniform

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163840,
    block_pattern=uniform("attn", 61),
    mlp_kind="moe",
    n_experts=384,
    experts_per_token=8,
    moe_d_ff=2048,
    rope_theta=50_000.0,
    source="arXiv:2501.kimi2",
)
