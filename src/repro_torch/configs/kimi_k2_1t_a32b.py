"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048
(per-expert hidden) vocab=163840, MoE 384 experts top-8 — trillion-param
MoE per the assignment's paper table [arXiv:2501.kimi2; unverified].

Note: the released Kimi K2 uses MLA attention; the assignment table
specifies GQA kv=8, which is what we implement (the assignment config is
authoritative for the dry-run)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,               # per-expert hidden
    vocab_size=163_840,
    head_dim=112,            # d_model / num_heads
    num_experts=384,
    num_experts_per_token=8,
    capacity_factor=1.25,
    rope_theta=50_000.0,
    act="silu",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="kimi-k2-1t-a32b-reduced",
        num_layers=3, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=64, vocab_size=512, head_dim=32, num_experts=8,
        num_experts_per_token=2, attn_chunk=64, remat="none",
    )
