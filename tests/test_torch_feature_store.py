"""The port's columnar ``FeatureStore`` and whole-batch ``_drop_self``
against the reference's dict-of-rows store and per-row loop.

Each store case drives both stores through one seeded sequence of
``put``, ``drop`` and ``gather`` calls and, after every step, holds the
port to the reference: the same ``ids()``, ``len``, ``in`` over a probe
set, and the same gathered arrays (dtype, shape and bits) for a probe
holding live, dropped, unknown and -1 ids. The ``_drop_self`` cases give
both the same rows; ids and distances must agree exactly."""
import tracemalloc

import numpy as np
import pytest

from repro.core.gus import FeatureStore as JFeatureStore
from repro.core.gus import _drop_self as j_drop_self
from repro.core.types import FeatureSpec as JFeatureSpec
from repro_torch.core.gus import FeatureStore, _drop_self
from repro_torch.core.types import FeatureSpec

SPEC = dict(dense={"text": 5}, sets={"tags": 3}, scalars=("year",))
BIG = 2 ** 40


def _stores():
    return (FeatureStore(FeatureSpec(**SPEC)),
            JFeatureStore(JFeatureSpec(**SPEC)))


def _features(rng, n):
    """Rows for ``n`` ids, in the spec's keys; the dense column in
    float64, which both stores cast to the spec's float32 alike."""
    return {"dense:text": rng.normal(size=(n, 5)),
            "set:tags": rng.integers(-1, 50, (n, 3)).astype(np.int32),
            "scalar:year": rng.uniform(0, 25, n).astype(np.float32)}


def _assert_same(t, j, probe):
    np.testing.assert_array_equal(t.ids(), j.ids())
    assert t.ids().dtype == np.int64
    assert len(t) == len(j)
    for pid in np.asarray(probe).reshape(-1).tolist():
        assert (pid in t) == (pid in j), pid
    got, want = t.gather(probe), j.gather(probe)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _run(script, seed=0):
    """Play ``script`` (("put", ids) / ("put_text", ids): the dense key
    alone / ("drop", ids) / ("gather", ids)) on both stores, checking
    after every step; returns the stores."""
    rng = np.random.default_rng(seed)
    t, j = _stores()
    seen = {-1, 7, BIG + 9}
    for op, ids in script:
        ids = np.asarray(ids, np.int64)
        seen.update(ids.reshape(-1).tolist())
        if op.startswith("put"):
            feats = _features(rng, ids.size)
            if op == "put_text":
                feats = {"dense:text": feats["dense:text"]}
            t.put(ids, feats)
            j.put(ids, feats)
            probe = ids
        elif op == "drop":
            t.drop(ids)
            j.drop(ids)
            probe = ids
        else:
            probe = ids
        _assert_same(t, j, probe)
        _assert_same(t, j, np.asarray(sorted(seen), np.int64))
    return t, j


STORE_CASES = {
    "duplicate_ids_in_one_put": [("put", [3, 1, 3, 2, 1, 3])],
    "overwrite_live_id": [("put", [0, 1, 2, 3]), ("put", [2, 9]),
                          ("put", [2])],
    "drop_absent_ids": [("put", [0, 1, 2]), ("drop", [5, 1, 1, -1, BIG]),
                        ("drop", [1]), ("drop", [])],
    "gather_padding_and_unknown": [("put", [4, 0, 2]),
                                   ("gather", [-1, 7, 2, -1, 10 ** 6, 0])],
    "two_d_ids": [("put", [0, 1, 2, 5]),
                  ("gather", [[0, -1, 5], [9, 2, -1]]),
                  ("gather", np.zeros((0, 4), np.int64))],
    "slot_reuse_after_drop": [("put", list(range(10))), ("drop", [2, 3, 7]),
                              ("put", [20, 3, 21]), ("drop", [20]),
                              ("put", [22, 23, 24, 25])],
    "growth_past_capacity": [("put", list(range(0, 1500))),
                             ("drop", list(range(0, 1500, 3))),
                             ("put", list(range(1400, 3100))),
                             ("put", list(range(9000, 9500)))],
    "ids_near_2_40": [("put", [BIG + 5, BIG + 1, BIG + 5, 3]),
                      ("drop", [BIG + 1, BIG + 77]),
                      ("put", [BIG, 2 * BIG, 4]),
                      ("gather", [[BIG, -1], [BIG + 1, 2 * BIG]])],
    "dense_then_sparse": [("put", list(range(50))), ("drop", [4, 5]),
                          ("put", [BIG + 3, 6]), ("drop", [7, BIG + 3]),
                          ("put", [7, 60])],
    "put_without_some_keys": [("put", [0, 1, 2]), ("put_text", [1, 5]),
                              ("drop", [0]), ("put_text", [0])],
    "negative_ids": [("put", [-5, 2, -1]), ("gather", [-1, -5, 2, -2]),
                     ("drop", [-1])],
}


@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_store_matches_reference(case):
    _run(STORE_CASES[case])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_store_matches_reference_on_a_seeded_stream(seed):
    """Random puts (repeats within a batch included), drops and gathers
    over the dense id range, then a jump past it."""
    rng = np.random.default_rng(100 + seed)
    script = []
    for step in range(40):
        hi = 3000 if step < 30 else BIG
        n = int(rng.integers(0, 200))
        kind = ("put", "put", "drop", "gather")[int(rng.integers(4))]
        ids = rng.integers(0, 3000, n)
        if hi == BIG and kind == "put":
            ids[: n // 4] += BIG
        if kind == "gather":
            ids = np.where(rng.random(n) < 0.2, -1, ids)
        script.append((kind, ids))
    _run(script, seed)


@pytest.mark.parametrize("ids, dense", [
    (np.arange(100_000, dtype=np.int64), True),
    (np.arange(4) + BIG, False),
    (np.asarray([3, 1, BIG - 1]), False),
])
def test_store_id_map_follows_the_ids(ids, dense):
    """Ids within a few times the capacity keep the dense table; an id
    near 2**40 turns the store to sorted keys, without an allocation in
    proportion to the id."""
    rng = np.random.default_rng(0)
    t, _ = _stores()
    tracemalloc.start()
    try:
        t.put(ids, _features(rng, ids.size))
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert t.dense == dense
    # the features themselves (44 B a row, twice while growing) and the map
    assert peak < 2 ** 20 + 200 * ids.size
    np.testing.assert_array_equal(t.ids(), np.sort(ids))
    assert t.gather(ids[:1])["scalar:year"].shape == (1,)


@pytest.mark.parametrize("sparse", [False, True])
def test_store_snapshot_restore_round_trip(sparse):
    """A snapshot of the port's store restores into a fresh port store
    and into the reference's store, which then agree at every step of a
    further stream; a restore drops rows the snapshot lacks."""
    off = BIG if sparse else 0
    t, j = _run([("put", np.arange(60) + off), ("drop", [off + 3, off + 8]),
                 ("put", [off + 3, off + 70])])
    snap = t.snapshot_state()
    np.testing.assert_array_equal(snap["ids"], j.snapshot_state()["ids"])
    t2, j2 = _stores()
    rng = np.random.default_rng(5)
    for store in (t2, j2):
        store.put([999], _features(rng, 1))        # a row the restore drops
        store.restore_state(snap)
    _assert_same(t2, j2, np.asarray([999, off + 8, off + 70, -1]))
    _assert_same(t2, j, np.asarray(snap["ids"]))
    feats = _features(rng, 3)
    for store in (t2, j2):
        store.put(np.asarray([off + 8, 1, off + 70]), feats)
        store.drop([off])
    _assert_same(t2, j2, np.asarray([off, off + 8, 1, off + 70]))
    empty, _ = _stores()
    empty.restore_state({"ids": np.zeros(0, np.int64), "features": {}})
    assert len(empty) == 0 and empty.ids().size == 0


def test_store_put_rejects_keys_outside_the_spec():
    t, _ = _stores()
    feats = _features(np.random.default_rng(0), 2)
    feats["dense:other"] = np.zeros((2, 5))
    with pytest.raises(ValueError, match="dense:other"):
        t.put(np.asarray([0, 1]), feats)
    assert len(t) == 0


# ------------------------------------------------------------ _drop_self

def _drop_case(name):
    """(ids, dists, self_ids, k) of one case."""
    rng = np.random.default_rng(len(name))
    d = lambda shape: rng.random(shape).astype(np.float32)  # noqa: E731
    if name == "self_absent":
        return np.asarray([[1, 2, 3, 4]]), d((1, 4)), np.asarray([9]), 3
    if name == "self_once":
        return np.asarray([[1, 2, 3, 4]]), d((1, 4)), np.asarray([3]), 3
    if name == "self_repeated":
        return np.asarray([[5, 5, 3, 7, 5]]), d((1, 5)), np.asarray([5]), 4
    if name == "padding_in_input":
        ids = np.asarray([[4, -1, -1, -1], [-1, 4, 2, -1], [2, 3, -1, -1]])
        dist = np.where(ids >= 0, d(ids.shape), np.inf).astype(np.float32)
        return ids, dist, np.asarray([4, 4, -1]), 3
    if name == "short_rows":
        return (np.asarray([[7, 7, 1], [2, 3, 4]]), d((2, 3)),
                np.asarray([7, 3]), 5)
    if name == "k_trims":
        return (np.asarray([[1, 2, 3, 4, 5], [6, 1, 7, 8, 9]]), d((2, 5)),
                np.asarray([0, 1]), 2)
    if name == "one_row":
        return np.asarray([[8, 3, 8]]), d((1, 3)), np.asarray([8]), 2
    if name == "rows_1024":
        ids = rng.integers(0, 200, (1024, 11)).astype(np.int64)
        self_ids = ids[:, 0].copy()
        ids[:, 5] = np.where(rng.random(1024) < 0.3, self_ids, ids[:, 5])
        ids[::7, -2:] = -1
        return ids, d((1024, 11)), self_ids, 10
    raise KeyError(name)


@pytest.mark.parametrize("case", [
    "self_absent", "self_once", "self_repeated", "padding_in_input",
    "short_rows", "k_trims", "one_row", "rows_1024"])
def test_drop_self_matches_reference(case):
    ids, dists, self_ids, k = _drop_case(case)
    got = _drop_self(ids, dists, self_ids, k)
    want = j_drop_self(ids, dists, self_ids, k)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape == (ids.shape[0], k)
        np.testing.assert_array_equal(g, w)
