"""Language-model configuration and the registry of the archs the port runs.

The port's own copy of ``repro.configs.base.ModelConfig`` (field for field,
defaults included) and of its ``get_config``. Each ported arch has a module
``repro_torch/configs/<id>.py`` with ``CONFIG`` (the published widths) and
``reduced()`` (a tiny same-family config for CPU tests), copied from the JAX
package. An arch whose layers the port does not have yet raises
``NotImplementedError`` naming the ROADMAP slice that brings it.
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

PORTED = ("granite-20b", "qwen3-8b", "internlm2-1.8b", "zamba2-1.2b",
          "kimi-k2-1t-a32b", "llama4-scout-17b-a16e", "rwkv6-3b")

# Where each arch not yet ported waits (ROADMAP.md section 1).
PENDING = {
    "gemma2-2b": "the gemma2 local/global stack",
    "qwen2-vl-72b": "the enc-dec and VLM slice (M-RoPE)",
    "seamless-m4t-medium": "the enc-dec and VLM slice",
}


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    if arch_id in PENDING:
        raise NotImplementedError(
            f"{arch_id} is not ported yet: it waits for {PENDING[arch_id]} "
            "(ROADMAP.md section 1)")
    if arch_id not in PORTED:
        raise ValueError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))
    return mod.reduced() if reduced else mod.CONFIG
