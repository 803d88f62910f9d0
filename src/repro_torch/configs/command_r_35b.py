"""Command R 35B — dense GQA, no bias, large vocab. [hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.config import ModelConfig, uniform

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    block_pattern=uniform("attn", 40),
    mlp_kind="dense",
    qkv_bias=False,
    rope_theta=8_000_000.0,
    tie_embeddings=True,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
