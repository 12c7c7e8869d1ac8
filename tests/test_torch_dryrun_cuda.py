"""The dry-run's cells on the card: at the reference's shrunk GUS cells of
2 and 4 shards the card's query, mutate and delete steps equal the same
steps on CPU copies of the card's state bit for bit, one full-size 16x16
query record (4,096 partitions x 8,192 slots, 4,096 queries) runs and
passes its check, a reduced architecture cell runs whole on the card
against the CPU, and a published architecture is swept on the meta
device. Run on the H100 with

    python -m pytest -q -m cuda tests/test_torch_dryrun_cuda.py

Without a card every test here skips (the ``card`` fixture decides).
"""
import os

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


def test_reduced_arch_cell_runs_whole_on_the_card(card, tmp_path):
    """A reduced architecture cell at its own shape (whisper, decode_32k:
    128 requests on a 32,768-token cache) run whole on the card: its
    first step within the check's bound of the same step on CPU copies
    of the first rows, its peak measured."""
    from repro_torch.configs import reduced_config
    rec = dryrun.run_cell("whisper-tiny", "decode_32k", False,
                          probes=False, cfg=reduced_config("whisper-tiny"),
                          device=card, whole=True, runs=2, check=True,
                          out_dir=str(tmp_path))
    assert rec["ran"] == "card" and rec["step_ms"] > 0
    assert rec["check"]["worst_share_of_bound"] <= 1.0
    assert rec["main"]["memory"]["peak_bytes"] > 0


def test_meta_sweep_of_a_published_arch(card, tmp_path):
    """qwen3-8b at its published config over every shape and both meshes
    on the card: no cell fits 85% of the card, so all are sized on the
    meta device with the card's limit in their plan, none fails, and the
    non-applicable long_500k cells are skipped."""
    from repro_torch.configs.base import SHAPES
    recs = dryrun.sweep(["qwen3-8b"], list(SHAPES), [False, True],
                        out_dir=str(tmp_path), device=card)
    assert len(recs) == 8 and len(os.listdir(tmp_path)) == 8
    assert not [r for r in recs if "error" in r]
    live = [r for r in recs if "skipped" not in r]
    assert len(live) == 6
    for rec in live:
        assert rec["ran"] == "meta" and rec["plan"]["fits"] is False
        assert rec["plan"]["need_gb"] > rec["plan"]["limit_gb"] > 0
        assert rec["corrected"]["flops"] == rec["main"]["flops"]
