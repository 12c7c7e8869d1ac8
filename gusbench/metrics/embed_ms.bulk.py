"""Time in the embedding generator per 1,024-id neighborhood RPC (ms)."""
from harness import readers as R


def read(t):
    return R.layer_ms_per_rpc(t, "query", ("embedding",))
