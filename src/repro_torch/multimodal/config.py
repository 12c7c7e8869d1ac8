"""Configuration for the multi-modal Grale scoring plane (port of
``repro/multimodal/config.py``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MultiModalConfig:
    """Knobs for the heterogeneous-feature scoring plane.

    Attached as ``GusConfig(multimodal=MultiModalConfig(...))``; ``None``
    (the default) keeps the dense-only serving path bitwise unchanged.

    The reference's ``rescore`` (its ``score_pairs`` backend) has no
    counterpart: the port has one rescore route, ``core.scorer.
    score_pairs``, which is the ``pair_score`` kernel on the card and its
    plain version on the CPU (the device decides).
    """

    sparse_k: int = 10          # sparse/bucket candidates unioned per query
    postings_cap: int = 64      # ids retained per bucket posting list
    d_sketch: int = 64          # count-sketch width for candidate ranking
    idf_size: int = 512         # IDF-S table size for routing re-weighting
    filter_percent: float = 1.0  # Filter-P: drop top-percent% buckets
    reload_every: int = 0       # table reloads every N applied batches
                                # (0 = tables frozen after bootstrap)

    def __post_init__(self) -> None:
        if self.sparse_k <= 0:
            raise ValueError("sparse_k must be positive")
