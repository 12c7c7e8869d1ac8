"""Online connected components over the maintained adjacency (port of
``repro/graph/cc.py``).

Labels are point ids and a component's label is the minimum id of its
members ("hash-to-min" propagation, Rastogi et al.): every active slot
repeatedly takes the min of its own label and its neighbors' labels until
nothing changes. ``DynamicGraphStore`` keeps the incrementality contract:
edge additions only merge components, so propagation from the stale
labels over the touched slots converges to the exact labels; components
that lost an edge are reset to their members' own ids first.

``propagate_labels`` is the reference's ``lax.while_loop`` as a host loop
that runs while the frontier has any bit set (one device-to-host sync per
round); labels and the round count equal the reference's.
``offline_components`` is the host union-find oracle.
"""
from __future__ import annotations

import numpy as np
import torch

# Label of a dead slot: larger than any point id (ids must fit int32).
DEAD_LABEL = np.int32(np.iinfo(np.int32).max)


def propagate_labels(labels: torch.Tensor, nbr_slots: torch.Tensor,
                     alive: torch.Tensor, active: torch.Tensor):
    """Hash-to-min fixpoint over the fixed-width adjacency.

    labels    int32 [cap]      current labels (point ids; DEAD_LABEL dead)
    nbr_slots int32 [cap, W]   symmetric adjacency, -1 empty
    alive     bool  [cap]
    active    bool  [cap]      initial dirty frontier

    Returns (labels, iterations). Each round an active slot takes the min
    over itself and its neighbors; slots adjacent to a change activate for
    the next round, and the loop ends when the frontier empties.
    """
    nbr_ok = nbr_slots >= 0
    safe = nbr_slots.clamp(min=0).long()
    dead = int(DEAD_LABEL)
    act = active & alive
    iters = 0
    while bool(act.any()):
        nbr_lab = torch.where(nbr_ok, labels[safe], dead)
        cand = torch.minimum(nbr_lab.amin(dim=-1), labels)
        new = torch.where(act & alive, cand, labels)
        changed = new != labels
        spread = (nbr_ok & changed[safe]).any(dim=-1)
        labels, act = new, (changed | spread) & alive
        iters += 1
    return labels, iters


def offline_components(pairs: np.ndarray, ids: np.ndarray) -> dict:
    """Union-find oracle: {point id -> min point id of its component} over
    an undirected edge list. Isolated ids label themselves."""
    parent = {int(i): int(i) for i in np.asarray(ids).reshape(-1).tolist()}

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:          # path compression
            parent[x], x = root, parent[x]
        return root

    for a, b in np.asarray(pairs).reshape(-1, 2).tolist():
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    return {i: find(i) for i in parent}


def propagate_flags(pairs: np.ndarray, weights: np.ndarray, ids: np.ndarray,
                    seed_ids, min_weight: float = 0.5) -> dict:
    """Label propagation over the maintained graph's connected components
    (the Android-Security consumer): a point is flagged iff it shares a
    component with a known-bad seed, over the subgraph of edges whose
    scored weight is >= ``min_weight``.

    pairs/weights come from ``DynamicGraphStore.edges()``; returns
    {point id -> flagged bool} over ``ids``.
    """
    pairs = np.asarray(pairs).reshape(-1, 2)
    weights = np.asarray(weights).reshape(-1)
    comp = offline_components(pairs[weights >= min_weight], ids)
    bad = {comp[int(s)] for s in np.asarray(seed_ids).reshape(-1).tolist()
           if int(s) in comp}
    return {i: lab in bad for i, lab in comp.items()}
