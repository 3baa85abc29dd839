"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Backbone only per the assignment: the vision frontend is a stub and
``input_specs()`` provides precomputed patch embeddings plus (3, B, S)
M-RoPE positions (temporal / height / width)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152_064,
    head_dim=128,
    mrope_sections=(16, 24, 24),   # sums to head_dim/2
    rope_theta=1_000_000.0,
    act="silu",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="qwen2-vl-72b-reduced",
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=512, head_dim=32, mrope_sections=(4, 6, 6),
        attn_chunk=64, remat="none",
    )
