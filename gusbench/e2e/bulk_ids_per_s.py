"""Ids whose neighborhoods were answered over the whole window: every
neighborhood RPC sent in it, over the time until the last returned."""


def read(t):
    ids = sum(r["req"].ids.size for r in t.requests
              if r["kind"] == "query" and r["ok"])
    span = t.t1 - t.t0
    return ids / span if ids and span > 0 else None
