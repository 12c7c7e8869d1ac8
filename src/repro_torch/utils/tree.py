"""Tree helpers shared by the training, checkpoint and optimizer modules
(port of ``repro/utils/tree.py``).

A tree is a nested dict (or list / tuple) of tensors, as the port's
params and optimizer state are. ``leaves`` walks it in the reference's
flatten order (``jax.tree.leaves``: dict keys sorted, sequences in
order), so a leaf's position and its ``/``-joined path match the
reference's.

``global_norm`` sums each leaf's f32 squares over flat slices of at most
``SLICE`` elements, so no leaf is ever copied whole to f32 (a stacked FFN
matrix of qwen3-8b is 1.81 G elements: 7.2 GB in f32).
"""
from __future__ import annotations

import torch

SLICE = 1 << 26                  # elements of the largest f32 temporary


def leaves_with_paths(tree, prefix: str = "") -> list:
    """(path, leaf) pairs in the reference's flatten order, each path its
    keys and indices joined with ``/``."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out += leaves_with_paths(sub, f"{prefix}/{key}" if prefix
                                 else str(key))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), in a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like, values):
    """A tree shaped like ``like`` holding ``values`` in ``leaves``'
    order."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def flat_slices(t: torch.Tensor):
    """Views of contiguous ``t`` flattened, ``SLICE`` elements at a time
    (the last one shorter)."""
    if not t.is_contiguous():
        raise ValueError(f"flat_slices: a {tuple(t.shape)} tensor is not "
                         f"contiguous")
    flat = t.view(-1)
    return [flat[lo:lo + SLICE] for lo in range(0, flat.numel(), SLICE)]


def tree_param_count(tree) -> int:
    return sum(t.numel() for t in leaves(tree))


def tree_size_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def tree_cast(tree, dtype):
    """Cast every floating-point leaf to ``dtype`` (ints and bools stay)."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    tree)


def tree_zeros_like(tree, dtype=None):
    return tree_map(lambda t: torch.zeros(t.shape, dtype=dtype or t.dtype,
                                          device=t.device), tree)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 squares (a 0-d f32 tensor on
    the leaves' device), each leaf summed over ``flat_slices``."""
    per_leaf = [sum(torch.sum(torch.square(s.float()))
                    for s in flat_slices(t)) for t in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(per_leaf)))
