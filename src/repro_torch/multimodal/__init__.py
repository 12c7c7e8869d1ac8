"""The multi-modal Grale scoring plane (port of ``repro/multimodal``).

  config.py   — ``MultiModalConfig``; attach via
                ``GusConfig(multimodal=...)`` (``None`` keeps the dense
                path bitwise unchanged);
  store.py    — ``MultiModalStore``: per-point sparse rows / bucket rows
                / count-sketches on the host, an inverted bucket posting
                index, and incrementally maintained IDF/filter routing
                tables (``core.idf.IdfCounts``), with snapshot and restore;
  retrieve.py — ``two_stage_neighbors``: dense-ANN ∪ sparse/bucket
                candidates, exact distances from the ``sparse_dot_batched``
                kernel, then the learned re-score through
                ``core.scorer.score_pairs`` (the ``pair_score`` kernel).
"""
from repro_torch.multimodal.config import MultiModalConfig
from repro_torch.multimodal.retrieve import two_stage_neighbors
from repro_torch.multimodal.store import MultiModalStore

__all__ = ["MultiModalConfig", "MultiModalStore", "two_stage_neighbors"]
