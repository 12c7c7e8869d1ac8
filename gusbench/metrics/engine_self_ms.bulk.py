"""Host time of a 1,024-id neighborhood RPC outside its embed, search and
score spans (ms): ``FeatureStore.gather``, the id maps, the host copies."""
from harness import readers as R


def read(t):
    return R.self_ms_per_rpc(t, "query", ("embedding", "index", "scoring"))
