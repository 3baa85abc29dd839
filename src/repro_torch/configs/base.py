"""Language-model configuration and the registry of the archs the port runs.

The port's own copy of ``repro.configs.base.ModelConfig`` (field for field,
defaults included) and of its ``get_config``. Each ported arch has a module
``repro_torch/configs/<id>.py`` with ``CONFIG`` (the published widths) and
``reduced()`` (a tiny same-family config for CPU tests), copied from the JAX
package. The port runs all ten archs of the JAX package's registry.

``ShapeConfig``, ``SHAPES``, ``shape_applicable``, ``ShardingConfig``,
``TrainConfig``, ``list_archs``, ``param_count``, ``active_param_count`` and
``model_flops_per_token`` are copies of the JAX package's too. On one device only ``ShardingConfig.microbatches`` acts, as
in the JAX package on a one-device mesh; on a mesh
(``launch/steps.build_program``) ``mode`` and ``zero`` act too.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int             # decoder layers for enc-dec
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                   # dense MLP hidden (per-expert hidden for MoE)
    vocab_size: int
    head_dim: int = 0           # 0 => d_model // num_heads

    # Attention variants
    qk_norm: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None   # local-attention window size
    local_global_period: int = 0           # >0: every Nth layer is global (rest local)
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE

    # MoE
    num_experts: int = 0
    num_experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM / hybrid
    ssm_state: int = 0          # Mamba2 d_state
    ssm_heads: int = 0          # Mamba2 heads (0 => derived)
    ssm_expand: int = 2         # Mamba2 expansion factor
    ssm_conv: int = 4           # conv1d width
    attn_every: int = 0         # zamba2: shared attn block after every Nth layer
    rwkv: bool = False
    rwkv_head_size: int = 64

    # Encoder-decoder
    encoder_layers: int = 0     # >0 => enc-dec; num_layers is the decoder depth

    # Misc architecture
    act: str = "silu"           # silu => SwiGLU, gelu => GeGLU
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    post_norm: bool = False     # gemma2-style additional post-block norms
    emb_scale: bool = False     # gemma-style sqrt(d_model) embedding scale

    # Numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # Implementation switches (do not change semantics). In the port,
    # attn_impl="kernel" sends prefill attention to ops.attention and
    # moe_impl="gmm" the expert products to ops.gmm (the CUDA kernels for
    # CUDA tensors, their plain versions for CPU tensors).
    attn_impl: str = "ref"      # ref (chunked plain torch) | kernel
    attn_chunk: int = 1024      # KV chunk for the chunked-ref path
    moe_impl: str = "dropping"  # dropping | einsum | dense | gmm | ep_a2a
    remat: str = "block"        # none | block | policy (training only)
    scan_layers: bool = True    # the JAX package's lax.scan switch; the port
                                # always loops over layers in Python
    scan_unroll: bool = False
    seq_parallel: bool = False  # Megatron-SP (multi-device slice)
    fuse_ffn: bool = True
    fuse_kv: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.rwkv

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


# The dry run's cells (``launch/dryrun.py``): every arch is paired with
# these four shapes.
SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    "train",   4_096,   256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768,  32),
    "decode_32k":  ShapeConfig("decode_32k",  "decode",  32_768,  128),
    "long_500k":   ShapeConfig("long_500k",   "decode",  524_288, 1),
}

# long_500k requires sub-quadratic context handling: run only for SSM /
# hybrid / linear-attention families.
LONG_CONTEXT_FAMILIES = ("hybrid", "ssm")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a valid dry-run cell; reason when not."""
    if shape.name == "long_500k" and cfg.family not in LONG_CONTEXT_FAMILIES:
        return False, "long_500k skipped: full-attention arch (sub-quadratic required)"
    return True, ""


@dataclass(frozen=True)
class ShardingConfig:
    mode: str = "dp_tp"        # dp_tp (params replicated over data) | fsdp_tp
    zero: int = 1              # 0: opt state like params; 1: opt sharded over data
    shard_cache_seq: bool = True   # decode: shard KV cache sequence over model axis
    grad_compress: str = "none"    # none | bf16 | int8_ef (cross-pod hop)
    remat_override: Optional[str] = None
    microbatches: int = 1      # gradient accumulation steps


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0


ARCH_IDS = [
    "granite-20b",
    "gemma2-2b",
    "qwen3-8b",
    "internlm2-1.8b",
    "zamba2-1.2b",
    "kimi-k2-1t-a32b",
    "llama4-scout-17b-a16e",
    "rwkv6-3b",
    "qwen2-vl-72b",
    "seamless-m4t-medium",
]

# Every arch of the registry; ``examples/train_100m_torch.py`` adds its own.
PORTED = tuple(ARCH_IDS)


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    if arch_id not in PORTED:
        raise ValueError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))
    return mod.reduced() if reduced else mod.CONFIG


def list_archs():
    return list(ARCH_IDS)


# ---------------------------------------------------------------------------
# Analytic parameter / FLOP accounting (used by roofline + sanity tests)
# ---------------------------------------------------------------------------

def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count for the configured model."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qo = cfg.num_heads * hd
    kv = cfg.num_kv_heads * hd
    attn = d * qo + 2 * d * kv + qo * d  # wq, wk, wv, wo
    if cfg.qk_norm:
        attn += 2 * hd
    gated = cfg.act in ("silu", "gelu")
    mlp_dense = (3 if gated else 2) * d * cfg.d_ff

    def block_norms():
        return (4 if cfg.post_norm else 2) * d

    total = 0
    if cfg.rwkv:
        # time-mix: r,k,v,g,o (d*d each) + decay/low-rank (approx) + channel mix
        tmix = 5 * d * d + 2 * d * 32 * 2  # lora-ish decay/mix params (approx)
        cmix = 2 * d * int(cfg.d_ff)
        total += cfg.num_layers * (tmix + cmix + 2 * d)
    elif cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * d
        mamba = (d * (2 * d_inner + 2 * cfg.ssm_state)  # in_proj(z,x) + B,C
                 + d_inner * cfg.ssm_conv                # conv
                 + d_inner                               # dt bias (per channel head)
                 + d_inner * d)                          # out_proj
        total += cfg.num_layers * (mamba + block_norms())
        n_attn = cfg.num_layers // max(cfg.attn_every, 1) if cfg.attn_every else 0
        if n_attn:
            total += attn + mlp_dense + block_norms()    # one shared block
    else:
        if cfg.is_moe:
            per_expert = (3 if gated else 2) * d * cfg.d_ff
            ffn = cfg.num_experts * per_expert + d * cfg.num_experts  # + router
        else:
            ffn = mlp_dense
        layers = cfg.num_layers + cfg.encoder_layers
        total += layers * (attn + ffn + block_norms())
        if cfg.encoder_layers:  # decoder cross-attention
            total += cfg.num_layers * (d * qo + 2 * d * kv + qo * d + d)
    total += cfg.vocab_size * d          # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d      # lm head
    total += d                           # final norm
    return int(total)


def active_param_count(cfg: ModelConfig) -> int:
    """Active params per token (MoE: top-k experts only)."""
    if not cfg.is_moe:
        return param_count(cfg)
    dense_like = param_count(cfg)
    gated = cfg.act in ("silu", "gelu")
    per_expert = (3 if gated else 2) * cfg.d_model * cfg.d_ff
    layers = cfg.num_layers + cfg.encoder_layers
    inactive = layers * (cfg.num_experts - cfg.num_experts_per_token) * per_expert
    return int(dense_like - inactive)


# Copied as it stands: the attention term has no factor of num_layers, so
# the count is low for deep models (ROADMAP.md section 3).
def model_flops_per_token(cfg: ModelConfig, seq_len: int, training: bool) -> float:
    """MODEL_FLOPS/token = 6*N_active (train) or 2*N_active (fwd) + attention."""
    n = active_param_count(cfg) - cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    mult = 6.0 if training else 2.0
    flops = mult * n
    # attention score flops: 2 * 2 * seq * qo per token (causal halves it)
    if not cfg.is_attention_free:
        qo = cfg.num_heads * cfg.resolved_head_dim
        window = seq_len
        if cfg.sliding_window and not cfg.local_global_period:
            window = min(seq_len, cfg.sliding_window)
        flops += mult / 1.5 * 2 * qo * (window / 2)
    # lm head
    flops += mult * cfg.d_model * cfg.vocab_size
    return flops
