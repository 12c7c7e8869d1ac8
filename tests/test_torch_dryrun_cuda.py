"""The dry-run's GUS cells on the card: at the reference's shrunk cells of
2 and 4 shards the card's query, mutate and delete steps equal the same
steps on CPU copies of the card's state bit for bit, and one full-size
16x16 query record (4,096 partitions x 8,192 slots, 4,096 queries) runs
and passes its check. Run on the H100 with

    python -m pytest -q -m cuda tests/test_torch_dryrun_cuda.py

Without a card every test here skips (the ``card`` fixture decides).
"""
import pytest
import torch

from repro_torch.ann import sharded as T
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_gus_mesh

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cpu(states):
    return [{key: t.cpu() for key, t in st.items()} for st in states]


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("merge", ["flat", "hier"])
def test_card_steps_equal_the_cpu(card, shards, merge):
    """Query (rows exactly, distances by their bits), mutate (routes, then
    every slab array) and delete (valid bits) on the card equal the same
    steps on CPU copies of the card's seeded state; "hier" on a 2-level
    grid of the same shards."""
    cell = dryrun.gus_cell(merge=merge, shards=shards)
    two_level = merge == "hier"
    mesh = make_gus_mesh(shards, two_level=two_level, device=card)
    cpu_mesh = make_gus_mesh(shards, two_level=two_level, device="cpu")
    states, inputs = T.seeded_cell(cell, mesh, seed=shards)
    cpu_states = _cpu(states)
    rows, dists = T.make_query_step(mesh, cell)(*inputs["query"], states)
    want_rows, want_d = T.make_query_step(cpu_mesh, cell)(
        *(t.cpu() for t in inputs["query"]), cpu_states)
    assert torch.equal(rows.cpu(), want_rows)
    assert torch.equal(dists.cpu().view(torch.int32),
                       want_d.view(torch.int32))
    assert torch.isfinite(want_d).float().mean() > 0.9
    states, routes = T.make_mutate_step(mesh, cell)(*inputs["mutate"],
                                                    states)
    cpu_states, want_routes = T.make_mutate_step(cpu_mesh, cell)(
        *(t.cpu() for t in inputs["mutate"]), cpu_states)
    for got, want in zip(routes, want_routes):
        assert torch.equal(got.cpu(), want)
    for key in T.MUTABLE:
        assert torch.equal(T.global_array(states, key),
                           T.global_array(cpu_states, key)), key
    sites = [r.reshape(-1) for r in routes]
    states = T.make_delete_step(mesh, cell)(*sites, states)
    cpu_states = T.make_delete_step(cpu_mesh, cell)(
        *(s.cpu() for s in sites), cpu_states)
    assert torch.equal(T.global_array(states, "valid"),
                       T.global_array(cpu_states, "valid"))


def test_full_size_query_record(card, tmp_path):
    """The default cell on the 16x16 mesh, every shard on the card: the
    query record passes its check (64 queries bit for bit the CPU copies'
    step) and carries the card's memory, step time and a profiled step."""
    rec = dryrun.run_gus_cell(False, str(tmp_path), device=card, runs=1,
                              check=True, profile=True)
    assert (rec["mesh"], rec["kind"], rec["shards"]) == ("16x16",
                                                         "gus_query", 256)
    assert rec["check"]["bitwise"]
    assert rec["check"]["finite_nonzero_share"] >= 0.9
    memory = rec["main"]["memory"]
    assert memory["temp_bytes"] > 0 and memory["code_bytes"] > 0
    assert rec["step_ms"] > 0
    assert 0 < rec["profile"]["device_busy_ms"] <= rec["profile"]["wall_ms"]
