"""Plain PyTorch versions of the Mamba2 state-space-dual (SSD) scan. The
port's copy of ``repro/kernels/mamba2_ssd/ref.py``.

Contract (shared by the plain versions and the CUDA kernel):

    y, final_state = ssd(x, log_a, b, c, initial_state, chunk)

    x:      (B, L, H, P)   inputs, already scaled by dt
    log_a:  (B, L, H)      per-step log decay, log a_t <= 0
    b:      (B, L, G, N)   input projections  (G groups; H % G == 0)
    c:      (B, L, G, N)   output projections
    state:  (B, H, P, N)

    recurrence (per head h with group g = h * G // H):
        S_t = a_t * S_{t-1} + x_t (outer) b_t
        y_t = S_t @ c_t

y comes back in x's dtype, the state in f32.
"""
from __future__ import annotations

import torch


def _expand_groups(t, H):
    """(B, L, G, N) -> (B, L, H, N) by repeating each group."""
    rep = H // t.shape[2]
    return t.repeat_interleave(rep, dim=2) if rep > 1 else t


def _initial(initial_state, B, H, P, N, device):
    if initial_state is None:
        return torch.zeros(B, H, P, N, dtype=torch.float32, device=device)
    return initial_state.float()


def ssd_naive(x, log_a, b, c, initial_state=None):
    """Step-by-step scan; the ground-truth oracle for tests."""
    B, L, H, P = x.shape
    N = b.shape[-1]
    bf = _expand_groups(b.float(), H)
    cf = _expand_groups(c.float(), H)
    xf = x.float()
    af = torch.exp(log_a.float())
    s = _initial(initial_state, B, H, P, N, x.device)
    ys = []
    for t in range(L):
        s = s * af[:, t, :, None, None] + xf[:, t, :, :, None] * bf[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", s, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), s


def _segsum(log_a):
    """(..., Q) -> (..., Q, Q) lower-triangular pairwise decay sums:
    out[i, j] = sum_{j < s <= i} log_a[s]  (i >= j), -inf above diagonal."""
    Q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]          # cum[i] - cum[j]
    i = torch.arange(Q, device=log_a.device)
    mask = i[:, None] >= i[None, :]
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, log_a, b, c, initial_state=None, chunk: int = 128):
    """Chunked SSD: quadratic intra-chunk attention + inter-chunk recurrence,
    all in f32. The plain version the CUDA kernel is held against."""
    B, L, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, L)
    assert L % Q == 0, (L, Q)
    nc = L // Q

    xf = x.float().reshape(B, nc, Q, H, P)
    la = log_a.float().reshape(B, nc, Q, H)
    bf = _expand_groups(b.float(), H).reshape(B, nc, Q, H, N)
    cf = _expand_groups(c.float(), H).reshape(B, nc, Q, H, N)
    s = _initial(initial_state, B, H, P, N, x.device)

    # intra-chunk ("attention") term, computed in parallel over chunks
    la_t = la.movedim(-1, 2)                            # (B,nc,H,Q)
    Lmat = torch.exp(_segsum(la_t))                     # (B,nc,H,Q,Q)
    scores = torch.einsum("bnihs,bnjhs->bnhij", cf, bf)  # (B,nc,H,Q,Q)
    y_intra = torch.einsum("bnhij,bnjhp->bnihp", scores * Lmat, xf)

    # per-chunk aggregated state contribution and total decay
    cum = torch.cumsum(la_t, dim=-1)                    # (B,nc,H,Q)
    total = cum[..., -1:]                               # (B,nc,H,1)
    decay_to_end = torch.exp(total - cum)               # (B,nc,H,Q)
    chunk_state = torch.einsum("bnjhs,bnhj,bnjhp->bnhps",
                               bf, decay_to_end, xf)    # (B,nc,H,P,N)

    # inter-chunk recurrence over nc steps
    s_prevs = []
    for n in range(nc):
        s_prevs.append(s)
        s = s * torch.exp(total[:, n])[..., None] + chunk_state[:, n]
    s_prev = torch.stack(s_prevs, dim=1)                # (B,nc,H,P,N)

    # inter-chunk output: y_t += C_t . (decay_in(t) * S_prev)
    decay_in = torch.exp(cum)                           # (B,nc,H,Q)
    y_inter = torch.einsum("bnihs,bnhi,bnhps->bnihp", cf, decay_in, s_prev)

    y = (y_intra + y_inter).reshape(B, L, H, P).to(x.dtype)
    return y, s


def ssd_step(x_t, log_a_t, b_t, c_t, state):
    """Single decode step. x_t (B,H,P); log_a_t (B,H); b/c (B,G,N);
    state (B,H,P,N) -> (y (B,H,P) in x_t's dtype, new_state in f32)."""
    H = x_t.shape[1]
    bf = _expand_groups(b_t[:, None].float(), H)[:, 0]
    cf = _expand_groups(c_t[:, None].float(), H)[:, 0]
    a = torch.exp(log_a_t.float())
    s = (state.float() * a[..., None, None]
         + x_t.float()[..., None] * bf[..., None, :])
    y = torch.einsum("bhpn,bhn->bhp", s, cf)
    return y.to(x_t.dtype), s
