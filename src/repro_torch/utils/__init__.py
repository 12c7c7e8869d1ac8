"""Small helpers: device selection, wall-clock timing, batch padding,
the tree walks and the HLO collective parser."""


def pow2_pad(n: int, cap: int | None = None) -> int:
    """Smallest power of two >= n (optionally clamped to ``cap``): the
    reference pads batches this way to bound jit recompiles; the port keeps
    it where the padded size is part of the contract (the engine's query
    batches, the graph store's initial capacity)."""
    p = 1
    while p < n:
        p *= 2
    return p if cap is None else min(p, cap)
