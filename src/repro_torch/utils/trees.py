"""Tree utilities over the port's state: nested dicts of tensors, named
tuples (``optim.adamw.AdamWState``), tuples and lists. The port of
``repro/utils/trees.py``.

Leaves are visited in the JAX package's order: dict keys sorted, named-tuple
fields and sequence items in order. ``tree_flatten_with_paths`` gives the
JAX key strings, so a checkpoint written by either package names its arrays
alike: dict keys as they are, named-tuple fields as ``.field`` and sequence
items by index, joined with ``/`` (``opt/.step``, ``opt/.m/tok/embed``).
"""
from __future__ import annotations

import math

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """[(path entry, child)] of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def _rebuild(tree, children):
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), children))
    if _is_namedtuple(tree):
        return type(tree)(*children)
    return type(tree)(children)


def _flatten(tree, path, out) -> None:
    kids = _children(tree)
    if kids is None:
        out.append(("/".join(path), tree))
        return
    for key, child in kids:
        _flatten(child, path + [key], out)


def tree_flatten_with_paths(tree):
    """[(path_string, leaf)] for every leaf, '/'-joined keys."""
    out = []
    _flatten(tree, [], out)
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_paths(tree)]


def tree_map(fn, tree, *rest):
    """fn over the leaves of ``tree`` (and the matching leaves of the trees
    in ``rest``, which have the same structure); returns a tree like
    ``tree``."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = [_children(r) for r in rest]
    return _rebuild(tree, [
        tree_map(fn, child, *(o[i][1] for o in others))
        for i, (_, child) in enumerate(kids)])


def tree_unflatten(like, leaves):
    """A tree with the structure of ``like`` and ``leaves`` in its order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_size_bytes(tree) -> int:
    """Total bytes of all tensor leaves in a tree."""
    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree_leaves(tree) if isinstance(leaf, torch.Tensor))


def tree_count_params(tree) -> int:
    """Total element count of all tensor leaves."""
    return sum(math.prod(leaf.shape) for leaf in tree_leaves(tree)
               if isinstance(leaf, torch.Tensor))


def tree_zeros_like(tree, dtype=None):
    return tree_map(lambda leaf: torch.zeros(
        leaf.shape, dtype=dtype or leaf.dtype, device=leaf.device), tree)


def tree_cast(tree, dtype):
    return tree_map(lambda leaf: leaf.to(dtype), tree)


def whole(t):
    """A DTensor as the whole tensor every rank then holds (reductions of a
    sharded tree meet in one value); a plain tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def tree_finite(tree) -> torch.Tensor:
    """True iff every leaf is finite everywhere (a 0-d bool tensor)."""
    leaves = [torch.isfinite(leaf).all() for leaf in tree_leaves(tree)]
    return torch.stack(leaves).all() if leaves else torch.tensor(True)


def tree_global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    leaves = [whole(leaf.float().square().sum())
              for leaf in tree_leaves(tree)]
    return (torch.stack(leaves).sum().sqrt() if leaves
            else torch.tensor(0.0))
