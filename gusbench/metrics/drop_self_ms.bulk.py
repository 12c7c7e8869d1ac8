"""Time of ``_drop_self`` per profiled 1,024-id neighborhood RPC (ms):
the program's ``gus.drop_self`` stage, the per-row loop that takes each
query's own id out of its row."""
from harness import stages as S


def read(t):
    return S.ms_per_rpc(t, "gus.drop_self")
