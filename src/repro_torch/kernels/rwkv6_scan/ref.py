"""Plain PyTorch versions of the RWKV6 ("Finch") WKV recurrence. The port's
copy of ``repro/kernels/rwkv6_scan/ref.py``.

Contract (shared by the plain versions and the CUDA kernel):

    y, final_state = wkv6(r, k, v, log_w, u, initial_state, chunk)

    r:      (B, L, H, K)   receptance
    k:      (B, L, H, K)   key
    v:      (B, L, H, V)   value
    log_w:  (B, L, H, K)   per-step, per-channel log decay (data-dependent)
    u:      (H, K)         "bonus" for the current token
    state:  (B, H, K, V)

    recurrence:
        y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
        S_t = diag(w_t) S_{t-1} + k_t v_t^T

All arithmetic is f32; y comes back in r's dtype, the state in f32.
"""
from __future__ import annotations

import torch


def _initial(initial_state, B, H, K, V, device):
    if initial_state is None:
        return torch.zeros(B, H, K, V, dtype=torch.float32, device=device)
    return initial_state.float()


def wkv6_naive(r, k, v, log_w, u, initial_state=None):
    """Step-by-step scan; the ground-truth oracle for tests."""
    B, L, H, K = r.shape
    V = v.shape[-1]
    rf, kf, vf = r.float(), k.float(), v.float()
    wf = torch.exp(log_w.float())
    uf = u.float()[..., None]                                  # (H,K,1)
    s = _initial(initial_state, B, H, K, V, r.device)
    ys = []
    for t in range(L):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]       # (B,H,K,V)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], s + uf * kv))
        s = s * wf[:, t, :, :, None] + kv
    return torch.stack(ys, dim=1).to(r.dtype), s


def wkv6_chunked(r, k, v, log_w, u, initial_state=None, chunk: int = 64):
    """Chunked WKV6: the sequential scan *within* each chunk (all chunks at
    once, from zero state) plus an analytic inter-chunk recurrence. Every
    decay factor is a product of per-step decays, exp of a sum of log w <= 0,
    so nothing overflows. The plain version the CUDA kernel is held
    against."""
    B, L, H, K = r.shape
    V = v.shape[-1]
    Q = min(chunk, L)
    assert L % Q == 0, (L, Q)
    nc = L // Q

    rf = r.float().reshape(B * nc, Q, H, K)
    kf = k.float().reshape(B * nc, Q, H, K)
    vf = v.float().reshape(B * nc, Q, H, V)
    lw = log_w.float().reshape(B * nc, Q, H, K)
    s = _initial(initial_state, B, H, K, V, r.device)

    # intra-chunk term from zero state, all chunks at once
    y_intra, chunk_state = wkv6_naive(rf, kf, vf, lw, u)
    y_intra = y_intra.reshape(B, nc, Q, H, V)
    chunk_state = chunk_state.reshape(B, nc, H, K, V)

    lw = lw.reshape(B, nc, Q, H, K)
    cum = torch.cumsum(lw, dim=2)                       # log prod_{s<=t}
    total = cum[:, :, -1]                               # (B,nc,H,K)
    decay_in = torch.exp(cum - lw)                      # prod_{s<=t-1} <= 1

    # inter-chunk recurrence over nc steps
    s_prevs = []
    for n in range(nc):
        s_prevs.append(s)
        s = s * torch.exp(total[:, n])[..., None] + chunk_state[:, n]
    s_prev = torch.stack(s_prevs, dim=1)                # (B,nc,H,K,V)

    # carry-in contribution: r_t . diag(prod_{s<=t-1} w) S_prev
    rd = rf.reshape(B, nc, Q, H, K) * decay_in
    y_inter = torch.einsum("bnihk,bnhkv->bnihv", rd, s_prev)

    y = (y_inter + y_intra).reshape(B, L, H, V).to(r.dtype)
    return y, s


def wkv6_step(r_t, k_t, v_t, log_w_t, u, state):
    """Single decode step. r/k/log_w (B,H,K), v (B,H,V), state (B,H,K,V)
    -> (y (B,H,V) in r_t's dtype, new state in f32)."""
    rf, kf, vf = r_t.float(), k_t.float(), v_t.float()
    wf = torch.exp(log_w_t.float())
    s = state.float()
    kv = kf[..., None] * vf[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", rf, s + u.float()[..., None] * kv)
    s = s * wf[..., None] + kv
    return y.to(r_t.dtype), s
