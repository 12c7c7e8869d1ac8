"""Device records launched by the MinHash set tables per profiled 16-id
neighborhood RPC on ogbn-products' schema: the records that start inside
the program's ``embed.minhash`` stage, their mean over the profiled
roots. The stage holds no other, so it is the innermost stage open at
each such record's start; records after it closes (the stacks of the
bucket columns) are not its own. None where no such stage opened or
no device record came back."""
import numpy as np

from harness import readers as R
from harness import stages as S


def read(t):
    roots = R.dev_spans(t, S.ROOT)
    stages = R.dev_spans(t, "embed.minhash")
    if not roots or not stages or not t.dev["ops"]:
        return None
    return float(np.mean([
        sum(len(R.ops_in(t, s, e)) for s, e, _ in R.within(stages, [root]))
        for root in roots]))
