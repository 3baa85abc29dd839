"""Plain PyTorch versions of the MPNN message step: on the dense edge tensor
(mirrors ``repro/kernels/mpnn_mp/ref.py``), and on the bond types and the
per-member edge matrices it is built from."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def message_pass_reference(h, edge_mat, adj):
    """h (B,N,Hd); edge_mat (B,N,N,Hd,Hd); adj (B,N,N) -> (B,N,Hd).

    m[b,i,k] = sum_j adj[b,i,j] sum_l edge_mat[b,i,j,k,l] h[b,j,l], in f32,
    returned in h's dtype."""
    return torch.einsum("bijkl,bjl,bij->bik",
                        edge_mat.float(), h.float(), adj.float()).to(h.dtype)


def message_pass_typed_reference(h, bonds, edge_w, adj):
    """h (E*B,N,Hd) or (E,B,N,Hd); bonds (B,N,N) int or (E,B,N,N); edge_w
    (E,nb,Hd*Hd); adj (B,N,N) or (E,B,N,N) -> h's shape and dtype.

    The step of ``message_pass_reference`` on the edge tensor
    edge_mat[e,b,i,j] = edge_w[e, bonds[b,i,j]] viewed as (Hd, Hd), without
    building it: the neighbours are first summed per bond type,
    g[e,b,i,t,l] = sum_j adj[b,i,j] [bonds[b,i,j] = t] h[e,b,j,l], then
    m[e,b,i,k] = sum_t sum_l g[e,b,i,t,l] edge_w[e,t,k*Hd+l], in f32."""
    E, nb = edge_w.shape[:2]
    N, hd = h.shape[-2:]
    x = h.float().reshape(E, -1, N, hd)
    a = adj.float()[..., None] * F.one_hot(bonds.long(), nb).float()
    a = a.expand(E, *a.shape[-4:])                          # (E,B,N,N,nb)
    g = torch.einsum("ebijt,ebjl->ebitl", a, x)
    m = torch.einsum("ebitl,etkl->ebik", g,
                     edge_w.float().reshape(E, nb, hd, hd))
    return m.reshape(h.shape).to(h.dtype)
