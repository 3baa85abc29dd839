"""seamless-m4t-medium [audio]: enc-dec, 12+12L d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206 [arXiv:2308.11596; hf].

Backbone only per the assignment: the speech frontend is a stub and
``input_specs()`` provides precomputed frame embeddings for the encoder."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,           # decoder
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,
    head_dim=64,
    rope_theta=10_000.0,
    act="gelu",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="seamless-m4t-medium-reduced",
        num_layers=2, encoder_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, d_ff=256, vocab_size=512, head_dim=32,
        attn_chunk=64, remat="none",
    )
