"""SeamlessM4T-medium — enc-dec multimodal (speech) transformer backbone.
[arXiv:2308.11596]

The conv/mel audio frontend is STUBBED: ``Model.prefill`` takes
precomputed frame embeddings of shape (batch, encoder_seq, d_model) as
``batch["frontend"]``; the encoder-decoder transformer consumes them.
"""
from repro_torch.config import ModelConfig, uniform

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    block_pattern=uniform("attn", 12),
    mlp_kind="dense",
    is_encoder_decoder=True,
    n_encoder_layers=12,
    encoder_seq=1024,  # stub frontend frame embeddings
    source="arXiv:2308.11596",
)
