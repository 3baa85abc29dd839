"""granite-20b [dense]: 52L d_model=6144 48H (GQA kv=1 / MQA) d_ff=24576
vocab=49152 — llama-arch code model [arXiv:2405.04324; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,          # multi-query attention
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    rope_theta=10_000.0,
    act="silu",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="granite-20b-reduced",
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=1,
        d_ff=256, vocab_size=512, head_dim=32, attn_chunk=64, remat="none",
    )
