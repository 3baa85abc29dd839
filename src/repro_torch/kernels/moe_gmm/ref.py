"""Plain PyTorch version of the grouped matmul: the port of
``repro/kernels/moe_gmm/ref.py::gmm_reference``."""
from __future__ import annotations

import torch


def gmm_reference(xe, w):
    """xe (G, M, D) @ w (G, D, F) -> (G, M, F) in xe's dtype: the products
    summed in f32 from the upcast inputs, rounded once."""
    return torch.einsum("gmd,gdf->gmf", xe.float(), w.float()).to(xe.dtype)
