"""Message-passing neural network surrogate (port of ``repro/models/mpnn.py``).

Dense-adjacency MPNN over molecular graphs: node states from one-hot atom
types, T message steps (an edge matrix per bond type applied to neighbour
states, summed over the dense adjacency) each followed by a GRU update, then
a masked-sum readout MLP to one scalar.

The message step takes one of two forms. Where it resolves to the kernel (on
CUDA tensors, ``impl`` None or "kernel"), each step calls
``mp_ops.message_pass_typed`` with the bond types and ``edge_w``: no edge
tensor is built, and pairs with adj = 0 are skipped. Where it resolves to
the plain version (CPU tensors, or ``impl="ref"``), forward builds the
(E*B, N, N, Hd, Hd) edge tensor from a one-hot GEMM, as the JAX package
does, adds its bytes to the ``edge_bytes`` counter, and each step calls
``mp_ops.message_pass`` on it.

The ensemble axis that the JAX package vmaps is written out: every parameter
carries a leading (E,) axis, node states are (E,B,N,Hd), and the message
kernel sees the flattened E*B batch. The inputs are one batch that every
member scores, or one batch per member (training's bootstrap samples).

Training runs no kernel. ``mpnn_loss`` takes the message step through the
plain version (``impl="ref"``, an einsum that autograd differentiates), as
the JAX loss runs ``mpnn_forward``'s default ``impl="ref"``: the ``mpnn_mp``
kernel computes the forward step only, in both packages, and has no backward.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import observability as obs
from repro_torch.configs.mpnn_surrogate import MPNNConfig
from repro_torch.kernels import dispatch
from repro_torch.kernels.mpnn_mp import ops as mp_ops


def param_shapes(cfg: MPNNConfig) -> dict[str, tuple[int, ...]]:
    """Names and (E, ...) shapes of the stacked parameters, in the order and
    with the names of ``repro.models.mpnn.mpnn_params``."""
    E, h, r = cfg.ensemble, cfg.hidden, cfg.readout_hidden
    return {
        "embed": (E, cfg.num_atom_types, h),
        "edge_w": (E, cfg.num_bond_types, h * h),
        "gru_wz": (E, 2 * h, h),
        "gru_wr": (E, 2 * h, h),
        "gru_wh": (E, 2 * h, h),
        "ro_w1": (E, h, r),
        "ro_b1": (E, r),
        "ro_w2": (E, r, 1),
        "ro_b2": (E, 1),
    }


def _init_scales(cfg: MPNNConfig) -> dict[str, float | None]:
    """Scale of each parameter's truncated normal, as ``InitMaker.param``
    gives it (``scale`` if set, else 1/sqrt(fan_in)); None means zeros."""
    h, r = cfg.hidden, cfg.readout_hidden
    return {
        "embed": 1.0, "edge_w": 0.05,
        "gru_wz": 1 / math.sqrt(2 * h), "gru_wr": 1 / math.sqrt(2 * h),
        "gru_wh": 1 / math.sqrt(2 * h),
        "ro_w1": 1 / math.sqrt(h), "ro_b1": None,
        "ro_w2": 1 / math.sqrt(r), "ro_b2": None,
    }


def _bmm(x, w):
    """Per-member matmul: x (E,B,N,D) @ w (E,D,F) -> (E,B,N,F)."""
    E, B, N, D = x.shape
    return torch.bmm(x.reshape(E, B * N, D), w).reshape(E, B, N, w.shape[-1])


# (E, N, Hd) activations a molecule holds at a typed message step's peak:
# h, m, cat([h, m]) (two), z, r, r*h, cat([r*h, m]) (two) and cand, the
# temporaries of the GRU update in ``MPNNEnsemble.forward``
TYPED_ACTIVATIONS = 10


def _typed(impl: str) -> bool:
    """Whether the message step resolved to ``impl`` takes the typed entry
    (bond types and edge matrices) and builds no edge tensor."""
    return impl in ("kernel", "meta")


class MPNNEnsemble(nn.Module):
    """E MPNNs evaluated together; forward returns (E, B) predictions."""

    def __init__(self, cfg: MPNNConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        scales = _init_scales(cfg)
        for name, shape in param_shapes(cfg).items():
            p = torch.zeros(shape)
            if scales[name] is not None:
                nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator).mul_(scales[name])
            self.register_parameter(name, nn.Parameter(p))

    def message_impl(self, lead: torch.Tensor, impl: str | None = None) -> str:
        """The message step's implementation for inputs on ``lead``'s
        device, as ``forward`` resolves it."""
        return dispatch.resolve(impl, "mpnn_mp", lead, self.edge_w)

    def bytes_per_molecule(self, n_atoms: int, impl: str) -> int:
        """Bytes of the forward's largest working set a molecule of
        ``n_atoms`` on the path ``impl`` (resolved) takes: the edge tensor,
        E*N*N*Hd*Hd values, on the plain path; TYPED_ACTIVATIONS (E, N, Hd)
        activations on the typed path, which builds no edge tensor."""
        cfg = self.cfg
        act = cfg.ensemble * n_atoms * cfg.hidden * self.embed.element_size()
        if _typed(impl):
            return TYPED_ACTIVATIONS * act
        return act * n_atoms * cfg.hidden

    def forward(self, atoms, bonds, mask, impl: str | None = None):
        """atoms (B,N) int; bonds (B,N,N) int (0 = none); mask (B,N) in
        {0,1}; or each with a leading (E,) axis, one batch per member. impl
        picks the message step (see ``mp_ops.message_pass``); None takes the
        kernel on CUDA (the typed entry, no edge tensor) and the plain
        version on the CPU (the edge tensor and its einsum)."""
        cfg = self.cfg
        E, hd = cfg.ensemble, cfg.hidden
        B, N = atoms.shape[-2:]
        mask = mask.to(self.embed.dtype)
        members = torch.arange(E, device=atoms.device)[:, None, None]
        h = self.embed[members, atoms.long()] * mask[..., None]   # (E,B,N,Hd)

        adj = (bonds > 0).to(h.dtype) * mask[..., :, None] * mask[..., None, :]
        impl = self.message_impl(h, impl)
        if _typed(impl):
            bonds = bonds.to(torch.int32)

            def step(h):
                return mp_ops.message_pass_typed(h, bonds, self.edge_w, adj,
                                                 impl=impl)
        else:
            nb = cfg.num_bond_types
            bond_oh = F.one_hot(bonds.long(), nb).to(h.dtype)
            edge_mat = torch.matmul(bond_oh.reshape(-1, B * N * N, nb),
                                    self.edge_w)                # (E,BNN,Hd*Hd)
            edge_mat = edge_mat.reshape(E * B, N, N, hd, hd)
            obs.counter("edge_bytes").inc(edge_mat.numel()
                                          * edge_mat.element_size())
            adj_eb = adj.expand(E, B, N, N).reshape(E * B, N, N)

            def step(h):
                return mp_ops.message_pass(h.reshape(E * B, N, hd), edge_mat,
                                           adj_eb, impl=impl).reshape(h.shape)

        for _ in range(cfg.message_steps):
            m = step(h)
            hm = torch.cat([h, m], dim=-1)
            z = torch.sigmoid(_bmm(hm, self.gru_wz))
            r = torch.sigmoid(_bmm(hm, self.gru_wr))
            cand = torch.tanh(_bmm(torch.cat([r * h, m], dim=-1), self.gru_wh))
            h = ((1 - z) * h + z * cand) * mask[..., None]

        pooled = (h * mask[..., None]).sum(dim=2)                 # (E,B,Hd)
        x = torch.relu(torch.bmm(pooled, self.ro_w1) + self.ro_b1[:, None])
        return (torch.bmm(x, self.ro_w2) + self.ro_b2[:, None])[..., 0]


def ucb(preds, kappa: float = 2.0):
    """Upper confidence bound over ensemble predictions (E, B) -> (B,), with
    the population std, as ``jnp.std`` takes it."""
    return preds.mean(dim=0) + kappa * preds.std(dim=0, correction=0)


def mpnn_loss(model: MPNNEnsemble, batch) -> torch.Tensor:
    """Per-member mean squared error, (E,): batch {"atoms","bonds","mask"}
    with a leading (E,) axis, one bootstrap sample per member, and "y"
    (E,B). The message step is the plain version (module docstring)."""
    pred = model(batch["atoms"], batch["bonds"], batch["mask"], impl="ref")
    return (pred - batch["y"]).square().mean(dim=-1)
