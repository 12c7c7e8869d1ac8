"""Runs of one tree repeat on the card: the index's offline training
(k-means and codebook training, whose per-center sums are
``index_add_``s) gives the same bits when run twice on the same inputs.
The graph phase of ``chip_smoke.py`` compares edge counts across runs,
which only works if this holds. Run on the H100 with

    python -m pytest -q -m cuda tests/test_torch_cuda_repeat.py

Without a card every test here skips (the ``card`` fixture decides).
"""
import numpy as np
import pytest
import torch

from repro_torch.ann import partition, quantize
from repro_torch.ann.scann import ScannConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _sketches(dev) -> torch.Tensor:
    """101,605 sketches of d_proj = 64: the main path's bootstrap."""
    rng = np.random.default_rng(0)
    return torch.as_tensor(rng.normal(size=(101_605, 64)).astype(np.float32),
                           device=dev)


def test_kmeans_repeats_bitwise(card):
    """661 partitions, the config's iterations and anisotropic weight."""
    cfg = ScannConfig()
    x = _sketches(card)
    runs = [partition.kmeans(x, 661, cfg.kmeans_iters, cfg.eta, 0)
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


def test_codebook_training_repeats_bitwise(card):
    """8 subspaces of 256 centers on residuals to 661 centroids."""
    cfg = ScannConfig()
    x = _sketches(card)
    cents = x[partition.sample_rows(x.shape[0], 661, 1, card)]
    p1, _ = partition.assign_partitions(x, cents, cfg.eta, 1.0)
    res = x - cents[p1]
    runs = [quantize.train_codebooks(res, cfg.pq_subspaces, cfg.pq_centers,
                                     cfg.pq_iters, cfg.eta, 0)
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
