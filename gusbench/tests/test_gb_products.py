"""The ``products-index`` configuration and the readers of its cell,
``products-index.reads``: the file as the benchmark loads it, the cell
run at a CPU size, and each reader on hand-built traces: the cell's own
(``*.products``) and the ``*.query`` readers it shares with
``arxiv-index.reads``, at this cell's shapes."""
import json
import math

import pytest

from harness import peaks, readers
from harness.runner import BENCH, cell_files, load_module, run_cell

CELL = "products-index.reads"
# the readers this cell adds, and the shared ones checked at its shapes
OWN = ("minhash_ms", "launches_minhash", "partitions_ms")
SHARED = ("embed_ms", "search_ms", "score_ms", "fused_query_roofline",
          "device_idle")
READERS = OWN + SHARED


def _read(name, t):
    kind = "products" if name in OWN else "query"
    return load_module(BENCH / "metrics" / f"{name}.{kind}.py").read(t)


def test_the_configuration_is_gus_configs_at_full_size(root):
    """Loaded through ``cell_files``: ogbn-products' 2,449,029 points and
    ``gus_config``'s partitions and probes for them, nothing cut."""
    from repro_torch.launch.serve import gus_config
    cfg, traffic, e2e, per_layer = cell_files(root, CELL)
    want = gus_config(2_449_029).scann
    assert cfg["corpus"]["n_points"] == 2_449_029
    assert cfg["index"]["n_partitions"] == want.n_partitions == 9_566
    assert cfg["index"]["nprobe"] == want.nprobe
    assert cfg["index"]["reorder"] == 512
    assert cfg["reduced"] == []
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(c for c in spec["configs"] if c["name"] == "products-index")
    assert entry["reduced"] == [] and entry["file"].endswith(
        "configs/products-index.json")
    assert traffic["cycle"] == [{"rpc": "query", "ids": 16, "k": 10}]
    assert {m["name"] for m in e2e} == {"setup_s", "query_rpcs_per_s"}
    query = {m["name"] for m in spec["per_layer"]
             if m["name"].endswith(".query")}
    assert len(query) == 13 and set(SHARED) <= {q[:-6] for q in query}
    assert {m["name"] for m in per_layer} == query | {f"{r}.products"
                                                      for r in OWN}


def test_the_cell_at_a_cpu_size_is_correct(root, tiny):
    """The real file with the tiny overrides (2,000 points, 16 partitions),
    traced: correct, and the readers of the program's stages and the
    benchmark's spans read; the device readers find no device record."""
    out = run_cell(root, CELL, 3_000_000_317, 1.0, True, device="cpu",
                   overrides=tiny)
    assert out["correct"], out["checks"]
    got = {name.split(".")[0]: m["value"]
           for name, m in out["metrics"].items()}
    for name in ("minhash_ms", "embed_ms", "search_ms", "score_ms",
                 "partitions_ms", "engine_self_ms", "gather_ms",
                 "drop_self_ms", "buckets_ms", "index_wait_ms"):
        assert math.isfinite(got[name]) and got[name] > 0, name
    assert got["minhash_ms"] < got["buckets_ms"]
    assert not {"launches", "launches_embed", "launches_index",
                "launches_minhash", "fused_query_roofline",
                "device_idle"} & set(got)


# two RPCs; ``embed.minhash`` inside ``embed.buckets``, the shortlist's
# kernel span with its call's shapes (lut [B, M, C], codes [B, N, M], the
# slots, r)
SHAPES = [[16, 8, 256], [16, 8192, 8], [16, 8192], 512, [16, 8192],
          [16, 8192], False]
DEV_SPANS = [
    ("rpc.query", 0.0, 400.0),
    ('gus.neighbors|{"ids": 16, "k": 11}', 1.0, 390.0),
    ('embed.to_device|{"bytes": 8}', 20.0, 30.0),
    ("embed.buckets", 31.0, 80.0),
    ('embed.minhash|{"tables": 6, "cap": 16}', 50.0, 78.0),
    ("embed.weights", 81.0, 110.0),
    ("index.partitions", 140.0, 160.0),
    ("kernel.fused_query|" + json.dumps(SHAPES), 165.0, 200.0),
    ("index.to_host", 201.0, 290.0),
    ("rpc.query", 500.0, 700.0),
    ('gus.neighbors|{"ids": 16, "k": 11}', 501.0, 690.0),
    ("embed.buckets", 510.0, 600.0),
    ('embed.minhash|{"tables": 6, "cap": 16}', 540.0, 590.0),
    ("index.partitions", 610.0, 640.0),
]
DEV_OPS = [
    ("fmix", 31.0, 31.5),            # SimHash: before embed.minhash opens
    ("uhash", 51.0, 52.0),           # embed.minhash
    ("amin", 77.0, 77.5),
    ("stack", 79.0, 79.2),           # after it closed, before the next leaf
    ("sort", 85.0, 86.0),            # embed.weights
    ("fused_chunk_kernel", 170.0, 180.0),
    ("uhash", 545.0, 546.0),         # the second RPC's embed.minhash
]


def _span(name, layer, rpc, t0, t1):
    return {"name": name, "layer": layer, "top": True, "rpc": rpc,
            "kind": "query", "t0": t0, "t1": t1}


HOST_SPANS = [
    _span("rpc.query", "engine", 0, 0.0, 0.010),
    _span("embed", "embedding", 0, 0.001, 0.004),
    _span("search", "index", 0, 0.004, 0.008),
    _span("score", "scoring", 0, 0.008, 0.009),
    _span("rpc.query", "engine", 1, 0.010, 0.020),
    _span("embed", "embedding", 1, 0.011, 0.016),
    _span("search", "index", 1, 0.016, 0.018),
    _span("score", "scoring", 1, 0.018, 0.0195),
]


def _run(spans=(), dev_spans=(), ops=()):
    dev = {"ops": list(ops), "spans": list(dev_spans), "t0_us": 0.0,
           "t1_us": 1000.0, "kind": "NVIDIA H100 80GB HBM3"}
    return readers.RunData(requests=[], t0=0, t1=1, setup_s=0,
                           spans=list(spans), dev=dev)


EXPECTED = {
    # (28 + 50) / 2 us of embed.minhash
    "minhash_ms": 39e-3,
    # the records that start inside it: 2 in the first RPC (not the SimHash
    # record before it, nor the stack after it), 1 in the second
    "launches_minhash": 1.5,
    "embed_ms": (3.0 + 5.0) / 2,
    "search_ms": (4.0 + 2.0) / 2,
    "score_ms": (1.0 + 1.5) / 2,
    "partitions_ms": (20 + 30) / 2 * 1e-3,
    # the bound at SHAPES over the kernel's 10 us
    "fused_query_roofline": 100.0 * peaks.bound_s(
        *peaks.fused_query_work(16, 8192, 8, 256, 512)) / 10e-6,
    # busy 0.5 + 1 + 0.5 + 0.2 + 1 + 10 of 400 us, and 1 of 200
    "device_idle": 1 - 14.2 / 600,
}


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_hand_built_trace(name):
    t = _run(HOST_SPANS, DEV_SPANS, DEV_OPS)
    assert _read(name, t) == pytest.approx(EXPECTED[name])


def _without(prefix):
    return [s for s in DEV_SPANS if not s[0].startswith(prefix)]


# for each reader, a trace without what it reads: the parent's program
# opens no ``embed.minhash`` stage; a trace without the benchmark's spans
ABSENT = {
    "minhash_ms": lambda: _run(HOST_SPANS, _without("embed.minhash"),
                               DEV_OPS),
    "launches_minhash": lambda: _run(HOST_SPANS, _without("embed.minhash"),
                                     DEV_OPS),
    "embed_ms": lambda: _run([s for s in HOST_SPANS
                              if s["layer"] != "embedding"], DEV_SPANS,
                             DEV_OPS),
    "search_ms": lambda: _run([], DEV_SPANS, DEV_OPS),
    "score_ms": lambda: _run([], DEV_SPANS, DEV_OPS),
    "partitions_ms": lambda: _run(HOST_SPANS, _without("index."), DEV_OPS),
    "fused_query_roofline": lambda: _run(HOST_SPANS, _without("kernel."),
                                         DEV_OPS),
    "device_idle": lambda: _run(HOST_SPANS, _without("rpc."), DEV_OPS),
}


@pytest.mark.parametrize("name", READERS)
def test_reader_without_what_it_reads_is_none(name):
    assert _read(name, ABSENT[name]()) is None
    assert _read(name, readers.RunData(requests=[], t0=0, t1=1,
                                       setup_s=0)) is None


def test_launches_minhash_without_device_records_is_none():
    """The stage opened but no device record came back (a CPU run)."""
    assert _read("launches_minhash", _run(HOST_SPANS, DEV_SPANS, ())) is None
