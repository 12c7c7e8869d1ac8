"""The readers of the program's stages (``harness/stages.py`` and the
``metrics/`` files that use it): on the tiny traced CPU cells, and on
hand-built traces, where the attribution of device records to the stage
that launched them is known."""
import json
import math
import re

import pytest

from harness import readers
from harness.runner import BENCH, load_module, run_cell

CELLS = {"arxiv-index.reads": "query", "arxiv-index.bulk": "bulk"}
STAGE_MS = ("gather_ms", "drop_self_ms", "buckets_ms", "index_wait_ms")
LAUNCHES = ("launches_embed", "launches_index")


def _read(name, t):
    return load_module(BENCH / "metrics" / f"{name}.py").read(t)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_stage_metrics_on_the_traced_cpu_cell(root, tiny, tiny_bulk, cell):
    """The four stage times come out finite and positive; the launch
    counts are left out, since the CPU run has no device records."""
    kind = CELLS[cell]
    over = tiny_bulk if kind == "bulk" else tiny
    out = run_cell(root, cell, 11, 1.5, True, device="cpu", overrides=over)
    assert out["correct"], out["checks"]
    for name in STAGE_MS:
        value = out["metrics"][f"{name}.{kind}"]["value"]
        assert math.isfinite(value) and value > 0, name
    for name in LAUNCHES:
        assert f"{name}.{kind}" not in out["metrics"]


def _run(spans, ops):
    dev = {"ops": ops, "spans": spans, "t0_us": 0.0, "t1_us": 1000.0}
    return readers.RunData(requests=[], t0=0, t1=1, setup_s=0, dev=dev)


# two RPCs; the benchmark's wrappers (``embed``, ``rpc.query``) are no stages
SPANS = [
    ("rpc.query", 0.0, 400.0),
    ('gus.neighbors|{"ids": 2, "k": 3}', 1.0, 390.0),
    ('gus.gather|{"rows": 2}', 2.0, 20.0),
    ("embed", 21.0, 120.0),
    ('embed.batch|{"rows": 2}', 22.0, 110.0),
    ('embed.to_device|{"bytes": 8}', 22.0, 30.0),
    ("embed.buckets", 31.0, 80.0),
    ("embed.weights", 81.0, 110.0),
    ('index.search|{"rows": 2, "k": 4}', 130.0, 300.0),
    ("index.sketch", 131.0, 150.0),
    ("index.to_host", 151.0, 290.0),
    ('gus.drop_self|{"rows": 2}', 300.0, 310.0),
    ('gus.gather|{"rows": 6}', 311.0, 340.0),
    ('score.pairs|{"rows": 6}', 341.0, 380.0),
    ("rpc.query", 500.0, 700.0),
    ('gus.neighbors|{"ids": 2, "k": 3}', 501.0, 690.0),
    ("embed.buckets", 510.0, 600.0),
    ('score.pairs|{"rows": 6}', 610.0, 680.0),
]
OPS = [
    ("Memcpy HtoD", 22.5, 23.0),          # embed.to_device's copy
    ("fmix", 31.0, 31.5),                 # opens with embed.buckets
    ("fmix", 79.0, 79.5),
    ("sort", 85.0, 86.0),                 # embed.weights
    ("sketch", 140.0, 141.0),             # index.sketch
    ("rescore", 151.5, 152.5),            # launched in index.sketch's wake,
                                          # starts inside index.to_host
    ("Memcpy DtoH", 289.0, 289.5),        # index.to_host
    ("pair_score", 360.0, 361.0),         # score.pairs
    ("fmix", 520.0, 521.0),               # the second RPC's embed.buckets
    ("pair_score", 690.5, 691.0),         # after its root closed: no RPC's
]


def test_each_record_goes_to_the_stage_that_launched_it():
    from harness import stages
    t = _run(SPANS, OPS)
    got = stages.launches_by_stage(t)
    assert got == [{"embed.to_device": 1, "embed.buckets": 2,
                    "embed.weights": 1, "index.sketch": 1,
                    "index.to_host": 2, "score.pairs": 1},
                   {"embed.buckets": 1}]
    assert _read("launches_embed.query", t) == pytest.approx((4 + 1) / 2)
    assert _read("launches_index.bulk", t) == pytest.approx(3 / 2)
    leaf_names = [n for n, _, _ in stages.leaves(stages._stages(t))]
    assert "embed.batch" not in leaf_names and "gus.neighbors" not in \
        leaf_names and leaf_names.count("gus.gather") == 2


def test_stage_times_per_rpc():
    t = _run(SPANS, OPS)
    # both gathers of the first RPC, none in the second: (18 + 29) / 2 us
    assert _read("gather_ms.query", t) == pytest.approx(47 / 2 * 1e-3)
    assert _read("buckets_ms.bulk", t) == pytest.approx((49 + 90) / 2 * 1e-3)
    assert _read("index_wait_ms.query", t) == pytest.approx(139 / 2 * 1e-3)
    assert _read("drop_self_ms.bulk", t) == pytest.approx(10 / 2 * 1e-3)


@pytest.mark.parametrize("kind", ["query", "bulk"])
def test_a_program_without_stages_reads_none(kind):
    """The parent's program opens no stage: every reader returns None
    and raises nothing, with or without device records."""
    wrappers = [s for s in SPANS if not s[0].startswith(
        ("gus.", "embed.", "index.", "score."))]
    for t in (_run(wrappers, OPS), _run(wrappers, []),
              readers.RunData(requests=[], t0=0, t1=1, setup_s=0)):
        for name in STAGE_MS + LAUNCHES:
            assert _read(f"{name}.{kind}", t) is None, name


def test_no_stage_takes_a_benchmark_span_name(root):
    """The program's stages (its ``stage("...")`` calls) start with a
    layer that ``harness/stages.py`` reads, and none is named as a span of
    ``spans/*.json``: the readers tell the two apart by name."""
    from harness import stages
    pat = re.compile(r"""\bstage\(\s*"([^"]+)\"""")
    names = {m for path in (root / "src" / "repro_torch").rglob("*.py")
             for m in pat.findall(path.read_text())}
    bench = {s["name"] for path in (BENCH / "spans").glob("*.json")
             for s in json.loads(path.read_text())["spans"]}
    assert names and bench and not names & bench
    assert all(name.startswith(stages.LAYERS) and "|" not in name
               for name in names)
