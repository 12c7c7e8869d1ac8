"""A configuration, a traffic mix and a per-layer metric are files found
by name: a new cell runs from new files and entries alone."""
import json
import shutil

from harness.runner import run_cell


def test_new_cell_from_new_files(root, tiny, tmp_path):
    bench = tmp_path / "gusbench"
    shutil.copytree(root / "gusbench", bench,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "arxiv-index.json").read_text())
    cfg["name"] = "arxiv-wide"
    cfg["index"]["nprobe"] = 12
    (bench / "configs" / "arxiv-wide.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "reads.json").read_text())
    mix["cycle"][0]["ids"] = 4
    (bench / "traffic" / "small-reads.json").write_text(json.dumps(mix))
    (bench / "metrics" / "queries.count.py").write_text(
        "def read(t):\n"
        "    return float(sum(r['kind'] == 'query' for r in t.requests))\n")
    spec["configs"].append({"name": "arxiv-wide", "source": "x",
                            "file": "gusbench/configs/arxiv-wide.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "arxiv-wide.small-reads",
                              "config": "arxiv-wide",
                              "traffic": "small-reads", "chips": 1,
                              "why": "x"})
    spec["per_layer"].append({"name": "queries.count", "unit": "requests",
                              "better": "higher", "source": "program_counter",
                              "layer": "engine", "moves": "query_rpcs_per_s",
                              "workloads": ["arxiv-wide.small-reads"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and "arxiv-index.reads" in m["workloads"]:
            m["workloads"].append("arxiv-wide.small-reads")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "gusbench" / "configs").mkdir(exist_ok=True)
    out = run_cell(tmp_path, "arxiv-wide.small-reads", 3, 1.0, True,
                   device="cpu", overrides=tiny, bench=bench)
    assert out["correct"], out["checks"]
    assert out["metrics"]["queries.count"]["value"] > 0
    assert "engine_self_ms.query" not in out["metrics"]
    plain = run_cell(tmp_path, "arxiv-wide.small-reads", 3, 1.0, False,
                     device="cpu", overrides=tiny, bench=bench)
    assert {"setup_s", "query_rpcs_per_s"} == set(plain["metrics"])
