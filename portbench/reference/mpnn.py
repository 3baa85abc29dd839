"""Plain reference of the MPNN-ensemble surrogate: the forward pass, the UCB
re-score, the loss and Adam, written from the model's description (the
paper's §II-B and ``repro/models/mpnn.py``'s equations), in plain torch.

Node states start from an embedding of the atom types; each of the T
message steps computes, for every atom i,

    m_i = sum_j adj_ij W[bond_ij] h_j,     adj_ij = [bond_ij > 0] mask_i mask_j

with one (Hd, Hd) matrix per bond type, then a GRU update

    z = sig([h, m] Wz),  r = sig([h, m] Wr),  c = tanh([r h, m] Wh),
    h = ((1 - z) h + z c) mask,

and a readout MLP sums the atoms' states and maps them to one scalar. The
message step is computed bond type by bond type, (A_t h) W_t^T with A_t the
adjacency of bond type t, which needs no (N, N, Hd, Hd) edge tensor; it is
the same sum. Every parameter has a leading ensemble axis E.

``dtype`` is the precision of the whole computation: float64 for the
reference, float32 (with TF32 matmuls where the caller enables them) for
the control.
"""
from __future__ import annotations

import numpy as np
import torch

NAMES = ("embed", "edge_w", "gru_wz", "gru_wr", "gru_wh", "ro_w1", "ro_b1",
         "ro_w2", "ro_b2")


def param_shapes(cfg: dict) -> dict:
    """(E, ...) shape of each stacked parameter, for the config's widths."""
    E, h, r = cfg["ensemble"], cfg["hidden"], cfg["readout_hidden"]
    return {
        "embed": (E, cfg["num_atom_types"], h),
        "edge_w": (E, cfg["num_bond_types"], h * h),
        "gru_wz": (E, 2 * h, h), "gru_wr": (E, 2 * h, h),
        "gru_wh": (E, 2 * h, h),
        "ro_w1": (E, h, r), "ro_b1": (E, r),
        "ro_w2": (E, r, 1), "ro_b2": (E, 1),
    }


def forward(params: dict, atoms, bonds, mask, cfg: dict):
    """params {name: (E, ...) tensor}; atoms, bonds, mask (B, ...) shared by
    all members, or (E, B, ...) one batch per member -> (E, B) outputs, in
    the parameters' dtype."""
    dt = params["embed"].dtype
    E, hd = cfg["ensemble"], cfg["hidden"]
    if atoms.dim() == 2:
        atoms, bonds, mask = (t.expand(E, *t.shape) for t in (atoms, bonds,
                                                               mask))
    atoms, bonds = atoms.long(), bonds.long()
    mask = mask.to(dt)
    members = torch.arange(E, device=atoms.device)[:, None, None]
    h = params["embed"][members, atoms] * mask[..., None]      # (E,B,N,Hd)
    pair = mask[..., :, None] * mask[..., None, :]
    adj = [(bonds == t).to(dt) * pair
           for t in range(1, cfg["num_bond_types"])]
    w = params["edge_w"].reshape(E, cfg["num_bond_types"], hd, hd)

    def mm(x, wt):                                   # (E,B,N,D) @ (E,D,F)
        return torch.einsum("ebnd,edf->ebnf", x, wt)

    for _ in range(cfg["message_steps"]):
        m = sum(torch.einsum("ebij,ebjl,ekl->ebik", a, h, w[:, t + 1])
                for t, a in enumerate(adj))
        hm = torch.cat([h, m], dim=-1)
        z = torch.sigmoid(mm(hm, params["gru_wz"]))
        r = torch.sigmoid(mm(hm, params["gru_wr"]))
        c = torch.tanh(mm(torch.cat([r * h, m], dim=-1), params["gru_wh"]))
        h = ((1 - z) * h + z * c) * mask[..., None]
    pooled = (h * mask[..., None]).sum(dim=2)                    # (E,B,Hd)
    x = torch.relu(torch.einsum("ebd,edf->ebf", pooled, params["ro_w1"])
                   + params["ro_b1"][:, None])
    return (torch.einsum("ebf,efo->ebo", x, params["ro_w2"])
            + params["ro_b2"][:, None])[..., 0]


def to_device(params_np: dict, device, dtype) -> dict:
    return {k: torch.as_tensor(np.asarray(v), device=device).to(dtype)
            for k, v in params_np.items()}


@torch.no_grad()
def rescore(params_np: dict, feats: dict, cfg: dict, y_mean: float,
            y_std: float, kappa: float, *, device, dtype=torch.float64,
            block: int = 2048) -> np.ndarray:
    """UCB scores (B,) of every molecule: the ensemble's predictions in the
    targets' units, their mean plus kappa times their population std."""
    params = to_device(params_np, device, dtype)
    preds = []
    for s in range(0, len(feats["atoms"]), block):
        f = [torch.as_tensor(np.asarray(feats[k][s:s + block]), device=device)
             for k in ("atoms", "bonds", "mask")]
        preds.append(forward(params, *f, cfg))
    p = torch.cat(preds, dim=1) * y_std + y_mean
    return (p.mean(0) + kappa * p.std(0, correction=0)).double().cpu().numpy()


def standardize(y) -> tuple[np.ndarray, float, float]:
    """Targets in units of their population std (at least 1e-3) about
    their mean."""
    y = np.asarray(y, np.float64)
    mean, std = float(y.mean()), float(max(y.std(), 1e-3))
    return (y - mean) / std, mean, std


def adam_train(params_np: dict, feats: dict, y, idx, cfg: dict, *, lr: float,
               steps: int, device, dtype=torch.float64, b1=0.9, b2=0.999,
               eps=1e-8, batch_share: float = 1.0) -> dict:
    """Full-batch Adam on each member's bootstrap sample ``idx`` (E, n) of
    the standardized targets, for ``steps`` steps. Returns the loss before
    each step (each member's, (E,)), the first step's gradient, and the
    parameters after the last step. ``batch_share`` < 1 takes each
    member's loss over that leading share of its sample (a planted fault:
    part of the batch left out)."""
    y_n, _, _ = standardize(y)
    idx = np.asarray(idx)
    batch = [torch.as_tensor(np.asarray(feats[k])[idx], device=device)
             for k in ("atoms", "bonds", "mask")]
    target = torch.as_tensor(y_n[idx], device=device).to(dtype)
    keep = max(1, int(round(idx.shape[1] * batch_share)))
    params = {k: v.clone().requires_grad_(True)
              for k, v in to_device(params_np, device, dtype).items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad1 = [], None
    for t in range(1, steps + 1):
        pred = forward(params, *batch, cfg)
        loss = (pred - target)[:, :keep].square().mean(dim=-1)      # (E,)
        grads = torch.autograd.grad(loss.sum(), list(params.values()))
        losses.append(loss.detach().double().cpu().numpy())
        if t == 1:
            grad1 = {k: g.detach().clone() for k, g in zip(params, grads)}
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
                p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
    return {"losses": losses,
            "grad1": {k: g.double().cpu().numpy() for k, g in grad1.items()},
            "params": {k: p.detach().double().cpu().numpy()
                       for k, p in params.items()}}
