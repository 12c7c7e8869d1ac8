"""Share of the profiled 1,024-id neighborhood RPCs' time with no device
record running."""
from harness import readers as R


def read(t):
    return R.idle_share(t, "rpc.query")
