"""Time the host waits for the index search's device work per profiled
16-id neighborhood RPC (ms): the program's ``index.to_host`` stage, the
copies of slots and distances to the host."""
from harness import stages as S


def read(t):
    return S.ms_per_rpc(t, "index.to_host")
