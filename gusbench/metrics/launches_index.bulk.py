"""Device records launched by the index search per profiled 1,024-id
neighborhood RPC: the records attributed to the program's ``index.*``
leaf stages."""
from harness import stages as S


def read(t):
    return S.launches_per_rpc(t, "index")
