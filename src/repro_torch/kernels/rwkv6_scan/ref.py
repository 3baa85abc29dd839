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


def _subchunk_decays(w, sub):
    """Per sub-chunk of ``sub`` steps (the last may be shorter) of w
    (B,Q,H,K): the exclusive prefix products inside the sub-chunk, the
    exclusive suffix products inside it, and its total product, each a
    product of factors <= 1."""
    lp, ls, tot = torch.ones_like(w), torch.ones_like(w), []
    for a in range(0, w.shape[1], sub):
        e = min(a + sub, w.shape[1])
        for t in range(a + 1, e):
            lp[:, t] = lp[:, t - 1] * w[:, t - 1]
        for t in range(e - 2, a - 1, -1):
            ls[:, t] = ls[:, t + 1] * w[:, t + 1]
        tot.append(lp[:, e - 1] * w[:, e - 1])
    return lp, ls, tot


def wkv6_subchunked(r, k, v, log_w, u, initial_state=None, chunk: int = 64,
                    sub: int = 16):
    """WKV6 in the arrangement of the bf16 CUDA kernel, all in f32: per
    chunk, the carry-in (r decayed to the chunk start) @ S, then the
    intra-chunk matrix A (Q,Q) in ``sub``-step sub-chunks, then y += A v and
    the state update. Off the diagonal, for t in sub-chunk I and j in an
    earlier sub-chunk J,

        A[t,j] = sum_k (r_t[k] prod_{s_J < s < t} w_s[k])
                       (k_j[k] prod_{j < s <= s_J} w_s[k]),

    s_J the last step of J: both factors are products of w <= 1, so neither
    overflows at any decay. On the diagonal blocks A[t,j] = sum_k r_t[k]
    k_j[k] prod_{j < s < t} w_s[k] for j < t, and the bonus r_t . (u k_t)
    for j = t, exactly. Every decay is a product of per-step factors; none
    is an exp of a cumsum difference. The bf16 CUDA kernel runs this with
    chunk=32, sub=8 (bf16-split tensor-core products in place of the f32
    einsums)."""
    B, L, H, K = r.shape
    V = v.shape[-1]
    Q = min(chunk, L)
    assert L % Q == 0, (L, Q)
    rf, kf, vf = r.float(), k.float(), v.float()
    wf = torch.exp(log_w.float())
    uf = u.float()
    s = _initial(initial_state, B, H, K, V, r.device)
    starts = list(range(0, Q, sub))
    ys = []
    for c0 in range(0, L, Q):
        rc, kc, vc, wc = (t[:, c0:c0 + Q] for t in (rf, kf, vf, wf))
        lp, ls, tot = _subchunk_decays(wc, sub)
        n = len(starts)
        pre = [torch.ones_like(tot[0])]                # prod of totals before I
        for i in range(n - 1):
            pre.append(pre[-1] * tot[i])
        suf = [torch.ones_like(tot[0])] * n            # prod of totals after J
        for i in range(n - 2, -1, -1):
            suf[i] = suf[i + 1] * tot[i + 1]
        A = torch.zeros(B, H, Q, Q, dtype=torch.float32, device=r.device)
        y = torch.zeros(B, Q, H, V, dtype=torch.float32, device=r.device)
        kd = torch.empty_like(kc)                      # k decayed to the chunk end
        for I, a in enumerate(starts):
            e = min(a + sub, Q)
            # carry-in: r_t prod_{s < t} w_s, all earlier sub-chunks whole
            rd = rc[:, a:e] * lp[:, a:e] * pre[I][:, None]
            y[:, a:e] = torch.einsum("bthk,bhkv->bthv", rd, s)
            kd[:, a:e] = kc[:, a:e] * ls[:, a:e] * suf[I][:, None]
            for J in range(I):
                ja, je = starts[J], starts[J] + sub
                mid = torch.ones_like(tot[0])
                for M in range(J + 1, I):
                    mid = mid * tot[M]
                rq = rc[:, a:e] * lp[:, a:e] * mid[:, None]
                kq = kc[:, ja:je] * ls[:, ja:je]
                A[:, :, a:e, ja:je] = torch.einsum("bthk,bjhk->bhtj", rq, kq)
            # diagonal block: running products prod_{j < s < t} w_s
            for j in range(a, e):
                d = torch.ones_like(kc[:, j])
                A[:, :, j, j] = torch.einsum("bhk,hk,bhk->bh", rc[:, j], uf,
                                             kc[:, j])
                for t in range(j + 1, e):
                    A[:, :, t, j] = (rc[:, t] * kc[:, j] * d).sum(-1)
                    d = d * wc[:, t]
        y = y + torch.einsum("bhtj,bjhv->bthv", A, vc)
        s = (s * (pre[-1] * tot[-1])[..., None]
             + torch.einsum("bjhk,bjhv->bhkv", kd, vc))
        ys.append(y)
    return torch.cat(ys, dim=1).to(r.dtype), s


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
