"""Neighborhood RPCs answered over the whole window: every one sent in
it, over the time until the last returned."""


def read(t):
    n = sum(r["kind"] == "query" and r["ok"] for r in t.requests)
    span = t.t1 - t.t0
    return n / span if n and span > 0 else None
