"""rwkv6-3b [ssm/linear-attention]: 32L d_model=2560 (attention-free)
d_ff=8960 vocab=65536 — "Finch", data-dependent decay [arXiv:2404.05892; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,            # d_model / rwkv_head_size
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    rwkv=True,
    rwkv_head_size=64,
    act="relu",              # squared-relu channel mix (set in rwkv6.py)
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="rwkv6-3b-reduced",
        num_layers=3, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=512, rwkv_head_size=32, attn_chunk=64,
        remat="none",
    )
