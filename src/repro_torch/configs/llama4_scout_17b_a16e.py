"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
(per-expert hidden) vocab=202048, MoE 16 experts top-1
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Note: released Scout adds a shared expert and interleaves dense layers;
the assignment table specifies a uniform MoE 16e top-1 stack, which is what
we implement."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,               # per-expert hidden
    vocab_size=202_048,
    head_dim=128,
    num_experts=16,
    num_experts_per_token=1,
    capacity_factor=1.25,
    rope_theta=500_000.0,
    act="silu",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="llama4-scout-17b-a16e-reduced",
        num_layers=3, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=64, vocab_size=512, head_dim=32, num_experts=4,
        num_experts_per_token=1, attn_chunk=64, remat="none",
    )
