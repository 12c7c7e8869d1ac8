"""The whole run (all but the look for a card) on the CPU at a tiny size:
sound, it is correct; with the timed path broken underneath in each way
the cells can be broken, or with the control (the reference in bfloat16)
in the program's place, ``correct`` comes out false. The mutation path,
which no cell runs yet, is held to the same on a cell added in a
temporary checkout."""
import numpy as np
import pytest

from harness.runner import merge, run_cell

CELLS = ["arxiv-index.reads", "arxiv-index.bulk"]
# batches of 4 ops: at this size no batch of the first seconds upserts an
# id twice, so the program fault of PERF.md's Open questions stays out
SMALL_BATCHES = {"traffic": {"batch": {"size": 4}}}


def _run(root, over, cell, hook=None, control=False, trace=False, seed=11,
         bench=None):
    kw = {"bench": bench} if bench is not None else {}
    return run_cell(root, cell, seed, 1.5, trace, device="cpu",
                    overrides=over, hook=hook, control=control, **kw)


def _tiny(cell, tiny, tiny_bulk):
    return tiny_bulk if cell.endswith(".bulk") else tiny


def _failing(out):
    return sorted(n for n, c in out["checks"].items()
                  if not c["value"] <= c["limit"])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, tiny, tiny_bulk, cell):
    out = _run(root, _tiny(cell, tiny, tiny_bulk), cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-2:] == ["checks", "_extra"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_is_correct(root, tiny, tiny_bulk, cell):
    out = _run(root, _tiny(cell, tiny, tiny_bulk), cell, trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]
    assert out["device"]["window_s"] > 0


def _half_batch_query(system):
    query = system.gus.neighbors_of_ids

    def half(ids, k=None):
        r = query(ids[: len(ids) // 2], k)
        pad = len(ids) - r.ids.shape[0]
        r.ids = np.concatenate([r.ids, np.full((pad, r.ids.shape[1]), -1)])
        r.weights = np.concatenate([r.weights, np.full(
            (pad, r.ids.shape[1]), -np.inf, np.float32)])
        r.distances = np.concatenate([r.distances, np.full(
            (pad, r.ids.shape[1]), np.inf, np.float32)])
        return r
    system.gus.neighbors_of_ids = half


def _weights_altered(system):
    query = system.gus.neighbors_of_ids

    def altered(ids, k=None):
        r = query(ids, k)
        r.weights = r.weights + np.float32(1e-3)
        return r
    system.gus.neighbors_of_ids = altered


def _ids_altered(system):
    query = system.gus.neighbors_of_ids

    def altered(ids, k=None):
        r = query(ids, k)
        r.ids = np.roll(r.ids, 1, axis=0)
        return r
    system.gus.neighbors_of_ids = altered


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_half_batch_query, _weights_altered,
                                   _ids_altered])
def test_fault_is_not_correct(root, tiny, tiny_bulk, cell, fault):
    out = _run(root, _tiny(cell, tiny, tiny_bulk), cell, hook=fault)
    assert not out["correct"]
    assert _failing(out)


@pytest.mark.parametrize("cell", CELLS)
def test_degraded_search_is_not_correct(root, tiny, tiny_bulk, cell):
    """One probe of 16 partitions instead of 8: the recall the index
    gives up fails ``recall_miss`` alone, at a limit between the two
    readings of this size (0.04-0.06 sound, 0.17-0.20 with one probe)."""
    over = merge(_tiny(cell, tiny, tiny_bulk),
                 {"config": {"limits": {"recall_miss": 0.11}}})
    assert _run(root, over, cell)["correct"]
    over = merge(over, {"config": {"index": {"nprobe": 1}}})
    assert _failing(_run(root, over, cell)) == ["recall_miss"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, tiny, tiny_bulk, cell):
    out = _run(root, _tiny(cell, tiny, tiny_bulk), cell, control=True)
    assert not out["correct"]
    assert {"weight_gap", "index_row_mismatch"} <= set(_failing(out))


# ------------------------------------------------- the mutation path

def _state_unchanged(system):
    system.gus.mutate = lambda batch: int(batch.ids.size)


def _half_batch_mutate(system):
    mutate = system.gus.mutate

    def half(batch):
        keep = batch.ids.size // 2
        batch.kinds, batch.ids = batch.kinds[:keep], batch.ids[:keep]
        batch.features = {k: v[:keep] for k, v in batch.features.items()}
        return mutate(batch)
    system.gus.mutate = half


@pytest.mark.parametrize("fault", [None, _state_unchanged,
                                   _half_batch_mutate, _weights_altered])
def test_mutation_cell(mutation_root, tiny, fault):
    root, bench = mutation_root
    out = _run(root, merge(tiny, SMALL_BATCHES), "arxiv-index.rpc-mix",
               hook=fault, bench=bench)
    if fault is None:
        assert out["correct"], out["checks"]
    else:
        assert not out["correct"] and _failing(out)


def test_program_stream_fails_the_mutation_cell(mutation_root, tiny):
    """The program fault of PERF.md's Open questions, caught by the
    comparison: with the program's 64-op batches, some upsert an id twice
    and leave orphan index entries."""
    root, bench = mutation_root
    out = _run(root, tiny, "arxiv-index.rpc-mix", bench=bench)
    assert "index_orphans" in _failing(out)
