"""Zamba2-7B — hybrid Mamba2 backbone with shared attention blocks.
[arXiv:2411.15242]

81 layers: Mamba2 blocks with a (shared-weight) full-attention transformer
block interleaved every 6th layer.  kv=32 with 32 heads = MHA in the shared
block.  d_model 3584 -> head_dim 112.
"""
from repro_torch.config import ModelConfig, every_kth

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=every_kth(81, "mamba2", "attn", 6),
    mlp_kind="dense",
    ssm_state=64,
    d_inner=7168,
    conv_width=4,
    mamba2_headdim=64,
    shared_block_kind="attn",  # interleaved attn blocks share weights
    source="arXiv:2411.15242",
)
