"""Synthetic molecular search space + deterministic QC oracle.

The benchmark's frozen copy of ``repro_torch/data/molecules.py``: the
molecule generator and the oracle that make the MPNN cells' inputs. The
benchmark imports nothing of the program to make its inputs, so a change to
the program's copy cannot change what is measured.

Simulated gate: the reproduction does not run NWChem, so
the "quantum chemistry" assay is a deterministic, expensive-ish spectral
computation on the molecular graph -- a fixed-point power iteration on a
graph Hamiltonian whose extreme eigenvalue plays the role of the ionization
potential.  It is (a) deterministic per molecule, (b) smooth in graph
structure (so an MPNN can learn it), and (c) has tunable cost, which is what
the Colmena experiments need (the paper's conclusions are about *steering*,
not about chemistry).

Molecules are random connected graphs ("QM9-like"): <= max_atoms atoms with
one-hot atom types and typed bonds.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class MoleculeSpace:
    num_molecules: int = 10_000
    max_atoms: int = 16
    num_atom_types: int = 8
    num_bond_types: int = 4
    seed: int = 42


def generate_molecule(space: MoleculeSpace, mol_id: int):
    """Deterministic molecule `mol_id` -> (atoms (N,), bonds (N,N), mask (N,))."""
    rng = np.random.default_rng(np.uint64(space.seed * 2_654_435_761 + mol_id))
    N = space.max_atoms
    n = int(rng.integers(6, N + 1))
    atoms = np.zeros(N, np.int32)
    atoms[:n] = rng.integers(0, space.num_atom_types, size=n)
    bonds = np.zeros((N, N), np.int32)
    # random spanning tree keeps the graph connected
    for i in range(1, n):
        j = int(rng.integers(0, i))
        b = int(rng.integers(1, space.num_bond_types))
        bonds[i, j] = bonds[j, i] = b
    # extra edges
    extra = int(rng.integers(0, n))
    for _ in range(extra):
        i, j = rng.integers(0, n, size=2)
        if i != j and bonds[i, j] == 0:
            b = int(rng.integers(1, space.num_bond_types))
            bonds[i, j] = bonds[j, i] = b
    mask = np.zeros(N, np.float32)
    mask[:n] = 1.0
    return atoms, bonds, mask


def featurize(space: MoleculeSpace, mol_ids):
    """Batch featurization -> {"atoms","bonds","mask"} numpy arrays."""
    mols = [generate_molecule(space, int(m)) for m in mol_ids]
    return {
        "atoms": np.stack([m[0] for m in mols]),
        "bonds": np.stack([m[1] for m in mols]),
        "mask": np.stack([m[2] for m in mols]),
    }


def qc_oracle(space: MoleculeSpace, mol_id: int, *, iters: int = 200) -> float:
    """Deterministic 'ionization potential' in [~4, ~12] V.

    Power iteration on H = A_weighted + diag(atom electronegativity); the
    dominant eigenvalue, squashed into a chemically plausible IP range."""
    atoms, bonds, mask = generate_molecule(space, mol_id)
    n = int(mask.sum())
    a = atoms[:n].astype(np.float64)
    W = bonds[:n, :n].astype(np.float64)
    # per-type "electronegativity" pattern
    chi = 1.0 + 0.7 * np.sin(1.0 + a * 1.3) + 0.05 * a
    H = 0.4 * W + np.diag(chi)
    v = np.ones(n) / np.sqrt(n)
    for _ in range(iters):
        v = H @ v
        v = v / max(np.linalg.norm(v), 1e-12)
    lam = float(v @ H @ v)
    # squash to an IP-like range; tail gives rare "high performers" > 10 V
    return 4.0 + 8.0 / (1.0 + np.exp(-(lam - 3.2)))


def oracle_batch(space: MoleculeSpace, mol_ids, **kw):
    return np.array([qc_oracle(space, int(m), **kw) for m in mol_ids],
                    np.float64)
