"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full power limit of 700 W). A share of a roofline
or of a peak is stated against these, with the card's power limit beside
it in ``PERF.md``."""
from __future__ import annotations

H100 = {
    "bf16_flops": 989e12,       # FLOP/s, tensor cores, dense
    "f32_flops": 67e12,         # FLOP/s outside the tensor cores
    "hbm_bytes": 3.35e12,       # bytes/s
}

DTYPE_FLOPS = {"bfloat16": H100["bf16_flops"], "float32": H100["f32_flops"]}


def bound_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take for ``flops`` operations in
    ``dtype`` and ``nbytes`` bytes moved: the larger of the two times."""
    return max(flops / DTYPE_FLOPS[dtype], nbytes / H100["hbm_bytes"])
