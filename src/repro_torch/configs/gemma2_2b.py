"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000
— local+global alternating attention, logit softcaps, sandwich norms,
tied embeddings [arXiv:2408.00118; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    d_ff=9216,
    vocab_size=256_000,
    head_dim=256,
    sliding_window=4096,
    local_global_period=2,      # [local, global] x 13
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_norm=True,
    emb_scale=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    act="gelu",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="gemma2-2b-reduced",
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=512, head_dim=32, sliding_window=32,
        attn_chunk=64, remat="none",
    )
