"""Time in the pair scorer per neighborhood RPC (ms)."""
from harness import readers as R


def read(t):
    return R.layer_ms_per_rpc(t, "query", ("scoring",))
