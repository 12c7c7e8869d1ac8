"""The open loop's schedule: the same gaps and the same count of each
kind for every seed, in an order the seed fixes; the closed loop's
cycles, made one at a time."""
import numpy as np

from harness import data
from harness.traffic import Plan

MIX = {"loop": "open", "rate_per_s": 50.0,
       "mix": [{"rpc": "query", "share": 3, "ids": 16, "k": 10},
               {"rpc": "mutate", "share": 1}],
       "batch": {}, "warmup": {"rounds": 1}}


def _plan(seed, mix=None):
    ids, feats, _ = data.make_dataset(data.CorpusConfig(
        n_points=800, n_clusters=10,
        spec=data.Spec(dense=(("text", 8),), scalars=("year",)), seed=0))
    stream = data.MutationStream(ids, feats, seed=1, bootstrap_fraction=0.6,
                                 batch_size=8)
    return Plan(MIX if mix is None else mix, stream, len(ids),
                np.random.default_rng(seed))


def _window(seed, seconds=4.0):
    return _plan(seed).window(seconds)


def test_schedule_repeats_for_a_seed():
    a, b = _window(7), _window(7)
    assert [r.due for r in a] == [r.due for r in b]
    assert [r.kind for r in a] == [r.kind for r in b]
    for x, y in zip(a, b):
        if x.kind == "query":
            np.testing.assert_array_equal(x.ids, y.ids)
        else:
            np.testing.assert_array_equal(x.batch.ids, y.batch.ids)


def test_every_seed_offers_the_same_load():
    seconds = 4.0
    a, b = _window(7, seconds), _window(8, seconds)
    assert len(a) == len(b) == 200
    assert sum(r.kind == "mutate" for r in a) == 50
    assert sorted(r.kind for r in a) == sorted(r.kind for r in b)
    assert [r.due for r in a] != [r.due for r in b]

    def gaps(w):
        due = np.asarray([r.due for r in w])
        # the first request is due at 0 and the gaps fill the window
        return np.sort(np.append(np.diff(due), seconds - due[-1]))
    np.testing.assert_allclose(gaps(a), gaps(b), rtol=0, atol=1e-9)
    assert max(r.due for r in a) < seconds and min(r.due for r in a) == 0.0


def test_queries_ask_for_live_ids():
    plan = _plan(3)
    live = set(plan.stream.live)
    for req in plan.window(2.0):
        if req.kind == "mutate":
            b = req.batch
            for kind, pid in zip(b.kinds.tolist(), b.ids.tolist()):
                (live.discard if kind == 2 else live.add)(pid)
        else:
            assert set(req.ids.tolist()) <= live


def test_closed_loop_makes_each_cycle_when_asked():
    mix = {"loop": "closed", "warmup": {"rounds": 1},
           "cycle": [{"rpc": "mutate"}, {"rpc": "query", "ids": 4, "k": 8}]}
    a, b = _plan(5, mix), _plan(5, mix)
    for _ in range(50):
        ca, cb = a.cycle(), b.cycle()
        assert [r.kind for r in ca] == ["mutate", "query"]
        np.testing.assert_array_equal(ca[0].batch.ids, cb[0].batch.ids)
        np.testing.assert_array_equal(ca[1].ids, cb[1].ids)
    assert len(a.batches) == 50
    assert a.batches[-1].version0 == 800 + 49 * 8
