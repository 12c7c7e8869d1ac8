"""Host time of ``FeatureStore.gather`` per profiled 1,024-id
neighborhood RPC (ms): the program's ``gus.gather`` stages, the query
rows' and the candidates'."""
from harness import stages as S


def read(t):
    return S.ms_per_rpc(t, "gus.gather")
