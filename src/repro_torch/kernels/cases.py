"""Inputs that hold each kernel against its plain version: seeded numpy
arrays at a given shape (the rescore step's, feature rows for the pair
score), plus the fused shortlist's edge cases (those of
``tests/test_kernels_fused.py``) and the top-k selection's.
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py`` both draw from
here, so the cases live in one place.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import PAD_INDEX, PAD_ITEM

FQ_ORDER = ("lut", "codes", "ids", "valid", "bias")


def fused_query_inputs(rng, b: int, n: int, m: int, c: int, id_pool: int,
                       tomb: float, ties: bool = False) -> dict:
    """lut [B,M,C], codes [B,N,M], ids [B,N] drawn from ``id_pool`` values
    (duplicates stand for SOAR copies), valid [B,N] with ``tomb`` of the
    slots tombstoned, bias [B,N]; ``ties`` draws scores from few values."""
    if ties:
        lut = rng.choice(np.asarray([-1.5, -0.25, 0.0, 0.5, 2.0], np.float32),
                         size=(b, m, c))
        bias = rng.choice(np.asarray([0.0, 0.75], np.float32), size=(b, n))
    else:
        lut = rng.normal(size=(b, m, c)).astype(np.float32)
        bias = rng.normal(size=(b, n)).astype(np.float32)
    return {"lut": lut, "codes": rng.integers(0, c, (b, n, m), dtype=np.uint8),
            "ids": rng.integers(0, id_pool, (b, n)).astype(np.int32),
            "valid": rng.random((b, n)) >= tomb, "bias": bias}


def fused_query_edge_cases(rng) -> list:
    """(name, inputs, k) for score ties with heavy duplicate ids, all-invalid
    rows, k = N, k = the number of live rows with every live id duplicated,
    and uniform scores (candidate order decides)."""
    live = fused_query_inputs(rng, 1, 12, 2, 4, 2, 0.0)
    live["ids"] = np.asarray([[5, 5, 7, 7, 9, 9, 1, 1, 2, 2, 3, 3]], np.int32)
    live["valid"] = np.asarray([[1, 1, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1]]) == 1
    uniform = {"lut": np.ones((1, 1, 2), np.float32),
               "codes": np.zeros((1, 8, 1), np.uint8),
               "ids": np.asarray([[4, 4, 4, 2, 2, 8, 8, 8]], np.int32),
               "valid": np.ones((1, 8), bool),
               "bias": np.zeros((1, 8), np.float32)}
    return [("ties+dups", fused_query_inputs(rng, 4, 160, 6, 24, 5, 0.4, True),
             64),
            ("all-invalid", fused_query_inputs(rng, 2, 17, 2, 4, 3, 1.0), 17),
            ("k=n", fused_query_inputs(rng, 2, 33, 3, 8, 10, 0.4), 33),
            ("k=live rows", live, 8),
            ("uniform", uniform, 8)]


def sparse_rows(rng, shape, vocab: int, unit: bool):
    """Sorted int64 indices below ``vocab`` with the last two of each row
    padding (``PAD_INDEX`` sorts last, value 0); unit or IDF-like values."""
    idx = np.sort(rng.integers(0, vocab, shape), axis=-1).astype(np.int64)
    idx[..., -2:] = PAD_INDEX
    val = (np.ones(shape, np.float32) if unit
           else (rng.random(shape) * 3 + 0.1).astype(np.float32))
    val[..., -2:] = 0.0
    return idx, val


def sparse_dot_cases(rng) -> list:
    """(name, [q_idx, q_val, db_idx, db_val, valid or None]) for the
    shared-db sparse dot: B = 1, 63, 64 and 300 (one, two and ten chunks
    of the kernel's 32 query rows) on a ragged N, Kq above and below Kd
    (Kq = 40 takes the kernel past the default shared memory), all-padding
    db and query rows, repeated indices in queries and db rows (a
    vocabulary of 12), and a row mask; IDF-like values."""
    def case(b, n, kq, kd, vocab=500):
        return [*sparse_rows(rng, (b, kq), vocab, False),
                *sparse_rows(rng, (n, kd), vocab, False), None]

    out = [(f"B={b}", case(b, 4099, 9, 9)) for b in (1, 63, 64, 300)]
    out += [("Kq=40 Kd=5", case(64, 4099, 40, 5)),
            ("Kq=3 Kd=16", case(64, 4099, 3, 16))]
    pads = case(40, 1000, 9, 9)
    pads[0][5] = PAD_INDEX                       # an all-padding query row
    pads[2][::7] = PAD_INDEX                     # all-padding db rows
    repeats = case(64, 3000, 9, 9, vocab=12)
    masked = case(64, 4099, 9, 9, vocab=50)
    masked[4] = rng.random(4099) < 0.7
    return out + [("padding rows", pads), ("repeated indices", repeats),
                  ("row mask", masked)]


def pq_score_cases(rng) -> list:
    """(name, lut, codes, shared) through every code-load path of the
    pq-score kernel: M = 4, 8, 16 (word loads) and 5 (bytes), C = 16 and
    256, ragged N, B = 1 and 300, both forms, and codes from a view one
    byte off their buffer (byte loads at M = 8)."""
    out = []
    for m, c, b, n, shared in ((4, 16, 1, 1001, False), (8, 256, 300, 777,
                                                        False),
                               (16, 256, 3, 4097, False),
                               (16, 16, 300, 1001, True),
                               (4, 256, 1, 70_001, True),
                               (8, 16, 17, 5000, True),
                               (5, 20, 3, 1001, False)):
        lut = rng.normal(size=(b, m, c)).astype(np.float32)
        codes = rng.integers(0, c, (n, m) if shared else (b, n, m),
                             dtype=np.uint8)
        out.append((f"M={m} C={c} B={b} N={n} "
                    f"{'shared' if shared else 'batched'}", lut, codes,
                    shared))
    lut = rng.normal(size=(16, 8, 256)).astype(np.float32)
    out.append(("offset view", lut, rng.integers(0, 256, (16, 999, 8),
                                                 dtype=np.uint8), False))
    return out


RESCORE_ORDER = ("q_idx", "q_val", "flat_slots", "short_pos",
                 "short_scores", "sp_idx", "sp_val")


def rescore_inputs(rng, b: int, n: int, r: int, cap: int, kd: int,
                   vocab: int, unit: bool) -> dict:
    """The index's rescore step at B queries, N probed candidates, a
    shortlist of r and a slab of ``cap`` rows of Kq = Kd = ``kd`` entries
    (``sparse_rows``: a small ``vocab`` with unit values makes exact ties
    across shortlist positions). 10% of the candidates are empty slots
    (-1) and 15% of the shortlist is -inf (tombstoned or a SOAR copy);
    row 0's shortlist is all -inf."""
    flat_slots = rng.integers(0, cap, (b, n)).astype(np.int32)
    flat_slots[rng.random((b, n)) < 0.1] = -1
    short_pos = np.stack([rng.choice(n, r, replace=False)
                          for _ in range(b)]).astype(np.int32)
    short_scores = -np.sort(rng.random((b, r)).astype(np.float32), axis=1)
    short_scores[rng.random((b, r)) < 0.15] = -np.inf
    short_scores[0] = -np.inf
    q_idx, q_val = sparse_rows(rng, (b, kd), vocab, unit)
    sp_idx, sp_val = sparse_rows(rng, (cap, kd), vocab, unit)
    return dict(q_idx=q_idx, q_val=q_val, flat_slots=flat_slots,
                short_pos=short_pos, short_scores=short_scores,
                sp_idx=sp_idx, sp_val=sp_val)


def feature_rows(rng, spec, rows: int) -> dict:
    """Feature rows of a ``FeatureSpec`` as the feature store holds them:
    dense f32 normal, sets int32 items from a pool of 40 with a ragged
    ``PAD_ITEM`` tail (some rows empty), scalars f32 years."""
    out = {}
    for name, dim in spec.dense.items():
        out[f"dense:{name}"] = rng.normal(size=(rows, dim)).astype(np.float32)
    for name, cap in spec.sets.items():
        items = rng.integers(0, 40, (rows, cap)).astype(np.int32)
        size = rng.integers(0, cap + 1, rows)
        items[np.arange(cap)[None, :] >= size[:, None]] = PAD_ITEM
        out[f"set:{name}"] = items
    for name in spec.scalars:
        out[f"scalar:{name}"] = rng.integers(1990, 2021, rows).astype(
            np.float32)
    return out


def scorer_inputs(rng, b: int, f: int, h: int) -> list:
    """feats [B,F] and the weights w0 b0 w1 b1 w2 b2 of an F-H-H-1 MLP."""
    shapes = [(b, f), (f, h), (h,), (h, h), (h,), (h, 1), (1,)]
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def topk_inputs(rng, b: int, n: int, ties: bool = False) -> np.ndarray:
    """scores f32 [B, N] as the graph gives them: edge weights in (0, 1)
    with -inf holes (empty or purged entries); ``ties`` draws them from few
    values, and then the first two rows are all -inf."""
    if ties:
        scores = rng.choice(np.asarray([0.25, 0.5, 0.75], np.float32), (b, n))
    else:
        scores = rng.random((b, n)).astype(np.float32)
    scores[rng.random((b, n)) < 0.3] = -np.inf
    if ties:
        scores[:2] = -np.inf
    return scores


def topk_edge_cases(rng) -> list:
    """(name, scores, k) for ties with all -inf rows at both graph shapes,
    k = N, k = 1, a 2M-entry row (489 chunks, merged in one block), and
    signed-zero ties in both of the reference's orders."""
    zeros = signed_zero_rows()
    return [("merge ties", topk_inputs(rng, 1024, 128, ties=True), 64),
            ("read ties", topk_inputs(rng, 16, 64, ties=True), 8),
            ("k=N", topk_inputs(rng, 7, 64, ties=True), 64),
            ("k=1", topk_inputs(rng, 3, 1000), 1),
            ("scratch", topk_inputs(rng, 2, 2_000_000), 3),
            ("signed zeros k<=64", zeros, 4),
            ("signed zeros k>64", zeros, 70)]


def signed_zero_rows() -> np.ndarray:
    """f32 [3, 80] rows where -0.0 and +0.0 tie: row 0 holds -0.0 at even
    and +0.0 at odd indices and 0.5 at index 5; row 1 is -0.0 but for
    +0.0 at index 3 and -inf at 60..79; row 2 is row 0 reversed."""
    rows = np.zeros((3, 80), np.float32)
    rows[0, 0::2] = -0.0
    rows[0, 5] = 0.5
    rows[1] = -0.0
    rows[1, 3] = 0.0
    rows[1, 60:] = -np.inf
    rows[2] = rows[0, ::-1]
    return rows


def topk_split_cases(chunk: int) -> list:
    """(name, scores, k) that cross the split of a long row into chunks of
    ``chunk``: equal values over eight chunks (expect 0..k-1, ties across
    chunk boundaries) and a ragged last chunk with signed zeros."""
    k = min(128, chunk // 2)
    ragged = np.full((2, 2 * chunk + chunk // 3), -0.0, np.float32)
    ragged[:, 1::7] = 0.0
    ragged[0, -3:] = [0.0, 1.0, -1.0]
    return [("equal values", np.full((2, 8 * chunk), 0.5, np.float32), k),
            ("ragged zeros", ragged, k)]


def fused_query_split_cases(rng, chunk: int) -> list:
    """(name, inputs, k) that cross the fused shortlist's split into chunks
    of ``chunk`` candidates: a ragged last chunk, a row shorter than one
    chunk with k = N, SOAR copies (same id, codes and bias) in different
    chunks, and all-invalid rows longer than one chunk."""
    k = min(128, chunk // 2)
    ragged = fused_query_inputs(rng, 2, 2 * chunk + chunk // 3, 4, 16,
                                chunk, 0.2, ties=True)
    n_short = chunk // 2 + 3
    short = fused_query_inputs(rng, 2, n_short, 4, 16, n_short // 2, 0.3)
    copies = fused_query_inputs(rng, 2, 3 * chunk, 4, 16, 2, 0.1, ties=True)
    first = np.arange(3 * chunk) % chunk      # copy j of point i at i + j*chunk
    copies["codes"] = copies["codes"][:, first]
    copies["bias"] = copies["bias"][:, first]
    copies["ids"] = np.tile(first.astype(np.int32), (2, 1))
    dead = fused_query_inputs(rng, 2, 2 * chunk + 5, 4, 16, 7, 1.0)
    return [("ragged chunk", ragged, k), ("short row k=N", short, n_short),
            ("copies across chunks", copies, k),
            ("all-invalid long", dead, k)]
