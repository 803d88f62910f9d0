"""Llama-3.2-Vision-90B — dense GQA decoder with cross-attention image layers.
[hf:meta-llama/Llama-3.2-11B-Vision]

The ViT vision encoder + projector are STUBBED: ``Model.prefill`` takes
precomputed patch embeddings (batch, n_image_tokens, d_model) as
``batch["frontend"]``.  Every 5th
layer cross-attends to them (20 cross layers out of 100).
"""
from repro_torch.config import ModelConfig, every_kth

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    block_pattern=every_kth(100, "attn", "cross", 5),
    mlp_kind="dense",
    rope_theta=500_000.0,
    n_image_tokens=1601,  # one 560x560 tile -> 1601 patch embeddings
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
