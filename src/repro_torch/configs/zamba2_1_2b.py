"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (kv=32, MHA) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf].

One shared attention block (one parameter set) runs after every
``attn_every`` Mamba2 layers, as in the JAX package's config: no LoRA
adapters per application and a single shared block instead of two
alternating ones."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    attn_every=6,           # 6 full groups of 6 + a 2-layer tail
    rope_theta=10_000.0,
    act="silu",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="zamba2-1.2b-reduced",
        num_layers=5, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=512, head_dim=32, ssm_state=16, attn_every=2,
        attn_chunk=64, remat="none",
    )
