"""The fused PQ shortlist's share of its roofline in the neighborhood
RPC (%): the least time its calls' work can take on the chip
(``peaks.fused_query_work`` at each call's shape) over the device time of
the records those calls launched."""
from harness import peaks
from harness import readers as R


def read(t):
    calls = R.within(R.dev_spans(t, "kernel.fused_query"),
                     R.dev_spans(t, "rpc.query"))
    bound = device = 0.0
    for s, e, shapes in calls:
        ops = R.ops_in(t, s, e)
        if not ops:
            continue
        (b, m, c), (_, n, _) = shapes[0], shapes[1]
        k = next(x for x in shapes[2:] if not isinstance(x, (list, bool)))
        bound += peaks.bound_s(*peaks.fused_query_work(b, n, m, c, k),
                               t.dev.get("kind"))
        device += sum(o[2] - o[1] for o in ops) * 1e-6
    return 100.0 * bound / device if device > 0 else None
