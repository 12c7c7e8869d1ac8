"""Host time of the embedding's MinHash set tables per profiled 16-id
neighborhood RPC on ogbn-products' schema (ms): the program's
``embed.minhash`` stage (6 tables of the uint32 hashing emulated in
int64 over each row's 16 set slots), inside ``embed.buckets``."""
from harness import stages as S


def read(t):
    return S.ms_per_rpc(t, "embed.minhash")
