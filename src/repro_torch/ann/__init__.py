"""ANN backends behind the Dynamic GUS index protocol
(``build / upsert / delete / search`` over ``SparseBatch`` embeddings):

  brute.py     — exact full-scan index (the recall oracle);
  scann.py     — quantized ScaNN-style index (partitions + residual PQ +
                 SOAR + exact rescore);
  sharded.py   — the sharded index's query / mutate / delete / compact
                 programs, one function per shard, the collectives
                 explicit;
  sharded_index.py — ``ShardedGusIndex``: those programs behind the index
                 protocol, with the slab lifecycle (compaction, growth,
                 skew re-splits) and versioned publishing;
  partition.py — k-means partitioner + SOAR assignment;
  quantize.py  — anisotropic product-quantization codebooks;
  sparse.py    — CountSketch projection and exact sparse dots.
"""
