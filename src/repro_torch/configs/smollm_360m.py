"""SmolLM-360M — llama-arch small dense model. [hf:HuggingFaceTB/SmolLM-135M]"""
from repro_torch.config import ModelConfig, uniform

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    block_pattern=uniform("attn", 32),
    mlp_kind="dense",
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
