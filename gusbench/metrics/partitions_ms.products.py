"""Host time of the index's partition selection per profiled 16-id
neighborhood RPC (ms): the program's ``index.partitions`` stage, the
queries scored against every centroid (9,566 on ogbn-products, 661 on
ogbn-arxiv) and the top ``nprobe`` taken."""
from harness import stages as S


def read(t):
    return S.ms_per_rpc(t, "index.partitions")
