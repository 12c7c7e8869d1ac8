"""Device records (kernels, copies, memsets) per profiled bulk
RPC."""
import numpy as np

from harness import readers as R


def read(t):
    spans = R.dev_spans(t, "rpc.query")
    if not spans or not t.dev["ops"]:
        return None
    return float(np.mean([len(R.ops_in(t, s, e)) for s, e, _ in spans]))
