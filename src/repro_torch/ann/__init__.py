"""ANN backends behind the Dynamic GUS index protocol
(``build / upsert / delete / search`` over ``SparseBatch`` embeddings):

  brute.py     — exact full-scan index (the recall oracle);
  scann.py     — quantized ScaNN-style index (partitions + residual PQ +
                 SOAR + exact rescore);
  partition.py — k-means partitioner + SOAR assignment;
  quantize.py  — anisotropic product-quantization codebooks;
  sparse.py    — CountSketch projection and exact sparse dots.
"""
