"""Gemma 3 12B — dense GQA, 5 local : 1 global attention, 128k context.
[hf:google/gemma-3-1b-pt family]"""
from repro_torch.config import ModelConfig, local_global

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    block_pattern=local_global(48, local=5),
    mlp_kind="dense",
    window=1024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)
