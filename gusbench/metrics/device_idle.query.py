"""Share of the profiled neighborhood RPCs' time with no device record
running."""
from harness import readers as R


def read(t):
    return R.idle_share(t, "rpc.query")
