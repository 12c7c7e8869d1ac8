"""Host time of the embedding's bucket hashing per profiled 16-id
neighborhood RPC (ms): the program's ``embed.buckets`` stage (the LSH
and the uint32 hashing emulated in int64, launched as many small
kernels)."""
from harness import stages as S


def read(t):
    return S.ms_per_rpc(t, "embed.buckets")
