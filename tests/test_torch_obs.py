"""The port's telemetry plane (``repro_torch.obs``) against the reference's
(``repro.obs``): the same sequence of records through both gives the
same snapshots, deltas and exporter text (histogram buckets and
percentiles included), the same traces, latency breakdown and events over
a fixed clock. Both are pure Python; the port keeps its own copy."""
import numpy as np
import pytest

from repro import obs as jobs
from repro_torch import obs as tobs


def _records(seed: int) -> list:
    """A seeded mixed sequence of instrument operations: counters,
    gauges (set and high-water mark), histograms on the default and on
    custom buckets, with values on the bucket bounds, below the first and
    above the last."""
    rng = np.random.default_rng(seed)
    bounds = list(tobs.DEFAULT_MS_BUCKETS)
    out = []
    for _ in range(400):
        op = rng.integers(5)
        if op == 0:
            out.append(("counter", f"obs_c{rng.integers(3)}_total",
                        int(rng.integers(1, 5))))
        elif op == 1:
            out.append(("set", f"obs_g{rng.integers(2)}",
                        float(rng.normal() * 10)))
        elif op == 2:
            out.append(("max", "obs_hw", float(rng.random() * 100)))
        elif op == 3:
            ms = (float(rng.choice(bounds)) if rng.random() < 0.3
                  else float(rng.lognormal(1.0, 2.0)))
            out.append(("observe", f"obs_h{rng.integers(2)}_ms", ms))
        else:
            out.append(("record", "obs_custom_ms", float(rng.random() * 0.2)))
    return out


def _replay(reg, records) -> None:
    for op, name, v in records:
        if op == "counter":
            reg.counter(name, "a counter").inc(v)
        elif op == "set":
            reg.gauge(name, "a gauge").set(v)
        elif op == "max":
            reg.gauge(name).max(v)
        elif op == "observe":
            reg.histogram(name, "latency").observe(v)
        else:
            reg.histogram(name, buckets=(1.0, 10.0, 100.0)).record(v)


@pytest.mark.parametrize("seed", [0, 1])
def test_registry_matches_reference(seed):
    """snapshot(), delta(), to_json() and to_prometheus() agree after the
    same records, and every histogram's summary() (the percentiles over
    its window) is the same dict."""
    records = _records(seed)
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    _replay(jreg, records[:200])
    _replay(treg, records[:200])
    jprev, tprev = jreg.snapshot(), treg.snapshot()
    assert jprev == tprev
    _replay(jreg, records[200:])
    _replay(treg, records[200:])
    assert treg.snapshot() == jreg.snapshot()
    assert treg.delta(tprev) == jreg.delta(jprev)
    assert treg.to_json(indent=1) == jreg.to_json(indent=1)
    assert treg.to_prometheus() == jreg.to_prometheus()
    assert treg.names() == jreg.names()
    for name in treg.names():
        t, j = treg.get(name), jreg.get(name)
        if t.kind == "histogram":
            assert t.bucket_counts == j.bucket_counts
            assert t.summary() == j.summary()
    with pytest.raises(ValueError):
        treg.gauge("obs_c0_total")                     # kind is sticky
    with pytest.raises(ValueError):
        treg.counter("Obs_Bad")                        # snake_case only


class _Clock:
    """A fixed clock: each read advances by the next step of a seeded
    sequence, the same for both packages."""

    def __init__(self, seed: int):
        self._steps = iter(np.random.default_rng(seed).random(10_000)
                           .tolist())
        self.now = 100.0

    def __call__(self) -> float:
        self.now += next(self._steps) * 1e-3
        return self.now


def _traffic(pkg, clock) -> tuple:
    """Sampled request groups through one tracer: queue waits backdated
    with add_span, primary / failover / hedge answers with injected
    latency, nested spans, events on a small ring."""
    tel = pkg.Telemetry(sample_every=3, clock=clock)
    tracer, events = tel.tracer, pkg.EventLog(keep=8)
    for g in range(20):
        tr = tracer.trace("group")
        with tracer.activate(tr):
            for q in range(1 + g % 3):
                t_adm = clock() - 0.002 * (q + 1)
                tracer.add_span("queue_wait", t_adm, clock())
            with tracer.span("engine_query", group=g):
                with tracer.span("answer_primary" if g % 4 else
                                 "answer_failover") as sp:
                    if sp is not None and g % 5 == 0:
                        sp.meta["extra_ms"] = 3.5
                if g % 6 == 0:
                    with tracer.span("answer_hedge"):
                        clock()
            tr.annotate(done=True)
        tracer.collect(tr)
        events.emit("hedge" if g % 6 == 0 else "failover", group=g)
    return tel, events


def test_tracer_and_events_match_reference():
    """The same traffic on a fixed clock gives the same span trees, the
    same latency breakdown, trace stats and retained events."""
    jtel, jev = _traffic(jobs, _Clock(3))
    ttel, tev = _traffic(tobs, _Clock(3))
    jfin, tfin = list(jtel.tracer.finished), list(ttel.tracer.finished)
    assert len(tfin) == len(jfin) == 7
    for jt, tt in zip(jfin, tfin):
        assert tt.problems() == jt.problems() == []
        assert ([(s.name, s.t0, s.t1, s.parent, s.meta) for s in tt.spans]
                == [(s.name, s.t0, s.t1, s.parent, s.meta) for s in jt.spans])
    assert (tobs.latency_breakdown(tfin) == jobs.latency_breakdown(jfin))
    assert ttel.snapshot() == jtel.snapshot()
    assert ([(e.seq, e.kind, e.fields) for e in tev]
            == [(e.seq, e.kind, e.fields) for e in jev])
    assert tev.counts() == jev.counts() and tev.seq == jev.seq == 20
    assert tev.last("hedge").seq == jev.last("hedge").seq
    assert tobs.NULL_TRACE.find("x") == [] and not tobs.NULL_TRACE.sampled
