"""The index's row-blocked argmin (``ann/partition.py::_blocked_argmin``):
the k-means, the primary and SOAR assignment and the PQ encoder give, a
block of rows at a time, what they give on the whole [N, C] cost at once;
a cost within ``COST_BLOCK_BYTES`` is one block, the unblocked tensors.

On the CPU a row of ``x[rows] @ c.T`` is summed as the same row of
``x @ c.T``, so the blocked results are equal bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.ann import partition as tpart
from repro_torch.ann import quantize as tpq

N, C, D = 3_000, 64, 64
M, PQ_C = 8, 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rows(seed, n, d=D):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n, d)).astype(np.float32))


def _bits(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.numpy()).view(np.uint8)


def _kmeans():
    return (tpart.kmeans(_rows(0, N), C, iters=4, eta=4.0, seed=3),)


def _assign():
    return tpart.assign_partitions(_rows(0, N), _rows(1, C), eta=4.0,
                                   soar_lambda=1.0)


def _encode():
    books = _rows(2, M * PQ_C, D // M).reshape(M, PQ_C, D // M)
    return (tpq.encode(_rows(0, N), books),)


# each case's cost width (float32 columns a row); under the test's budget
# a block holds ROWS rows: 5 blocks of N, the last one short
CASES = {"kmeans": (_kmeans, C), "assign": (_assign, C),
         "encode": (_encode, M * PQ_C)}
ROWS = 700


@pytest.mark.parametrize("case", sorted(CASES))
def test_blocked_equals_one_block(case, monkeypatch):
    run, width = CASES[case]
    whole = run()
    spans = []
    inner = tpart._blocked_argmin

    def recorded(n, w, fn):
        def block(rows):
            spans.append(rows)
            return fn(rows)
        return inner(n, w, block)
    monkeypatch.setattr(tpart, "COST_BLOCK_BYTES", 4 * width * ROWS)
    monkeypatch.setattr(tpart, "_blocked_argmin", recorded)
    monkeypatch.setattr(tpq, "_blocked_argmin", recorded)
    blocked = run()
    assert len(spans) >= 4
    assert all(s.stop - s.start == ROWS for s in spans[:4])
    assert 0 < spans[-1].stop - spans[-1].start < ROWS
    for a, b in zip(whole, blocked):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _blocks(n, width):
    """The row slices the helper hands its function for an [n, width]
    cost, read from the slices alone: nothing of that size is made."""
    seen = []

    def record(rows):
        seen.append(rows)
        return torch.empty(rows.stop - rows.start, dtype=torch.int64)
    tpart._blocked_argmin(n, width, record)
    return seen


@pytest.mark.parametrize("n, width, n_blocks", [
    (101_605, 661, 1),            # arxiv-index: k-means and assignment
    (101_605, M * PQ_C, 1),       # arxiv-index: the PQ encoder
    (1_469_417, 9_566, 53),       # products-index: 52.4 GiB unblocked
    (1_469_417, M * PQ_C, 12),    # products-index: the encoder, 11.2 GiB
])
def test_block_count_at_the_cells_shapes(n, width, n_blocks):
    seen = _blocks(n, width)
    assert len(seen) == n_blocks
    assert seen[0].start == 0 and seen[-1].stop == n
    assert all(a.stop == b.start for a, b in zip(seen, seen[1:]))
    assert all((s.stop - s.start) * width * 4 <= tpart.COST_BLOCK_BYTES
               for s in seen)
    if n_blocks == 1:
        assert seen == [slice(0, n)]
