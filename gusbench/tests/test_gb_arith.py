"""The end-to-end and roofline arithmetic."""
import numpy as np
import pytest

from harness import peaks, readers


def _req(kind, due, end, ok=True, ops=0):
    return {"kind": kind, "due": due, "start": due, "end": end, "ok": ok,
            "ops": ops}


def _reader(name):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "e2e" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rpc_rate_counts_every_answered_rpc_over_the_window():
    reqs = [_req("query", i * 0.01, i * 0.01 + 0.008) for i in range(100)]
    reqs += [_req("query", 1.0, 1.01, ok=False)]
    t = readers.RunData(requests=reqs, t0=0.0, t1=1.25, setup_s=1.0)
    assert _reader("query_rpcs_per_s").read(t) == pytest.approx(100 / 1.25)
    lat = readers.latencies_ms(t, "query")
    assert lat.size == 101 and np.isinf(lat[-1])


def test_rate_is_all_the_work_over_all_the_time():
    from types import SimpleNamespace
    mod = _reader("bulk_ids_per_s")

    def rpc(due, end, ok=True):
        return {**_req("query", due, end, ok),
                "req": SimpleNamespace(ids=np.arange(1024))}
    reqs = [rpc(i, i + 0.9) for i in range(10)]
    reqs += [rpc(10, 11.5, ok=False)]
    t = readers.RunData(requests=reqs, t0=0.0, t1=12.0, setup_s=1.0)
    assert mod.read(t) == pytest.approx(10 * 1024 / 12.0)


@pytest.mark.parametrize("shape,bound_ms", [
    # the kernel table's rows (PERF.md, fused_query): B, N, M, C, k
    ((16, 32768, 8, 256, 128), 0.0027),
    ((256, 32768, 8, 256, 128), 0.0433),
    ((16, 679936, 8, 256, 128), 0.0553),
    ((4096, 16384, 16, 256, 200), 0.5228),
])
def test_fused_query_bound_matches_the_kernel_table(shape, bound_ms):
    b, n, m, c, k = shape
    got = peaks.bound_s(*peaks.fused_query_work(b, n, m, c, k)) * 1e3
    assert got == pytest.approx(bound_ms, rel=0.02)


def test_idle_share_of_spans():
    dev = {"ops": [("k", 10.0, 20.0), ("k", 15.0, 30.0), ("k", 50.0, 60.0)],
           "spans": [("rpc.query", 0.0, 40.0), ("rpc.query", 40.0, 80.0)],
           "t0_us": 0.0, "t1_us": 80.0}
    t = readers.RunData(requests=[], t0=0, t1=1, setup_s=0, dev=dev)
    # busy 20 of 40 us in the first span, 10 of 40 in the second
    assert readers.idle_share(t, "rpc.query") == pytest.approx(1 - 30 / 80)
