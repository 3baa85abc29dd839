"""Plain PyTorch version of the MPNN message step (mirrors
``repro/kernels/mpnn_mp/ref.py``)."""
from __future__ import annotations

import torch


def message_pass_reference(h, edge_mat, adj):
    """h (B,N,Hd); edge_mat (B,N,N,Hd,Hd); adj (B,N,N) -> (B,N,Hd).

    m[b,i,k] = sum_j adj[b,i,j] sum_l edge_mat[b,i,j,k,l] h[b,j,l], in f32,
    returned in h's dtype."""
    return torch.einsum("bijkl,bjl,bij->bik",
                        edge_mat.float(), h.float(), adj.float()).to(h.dtype)
