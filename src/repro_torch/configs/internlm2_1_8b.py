"""internlm2-1.8b [dense]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544 [arXiv:2403.17297; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    head_dim=128,
    rope_theta=1_000_000.0,
    act="silu",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="internlm2-1.8b-reduced",
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=512, head_dim=32, attn_chunk=64, remat="none",
    )
