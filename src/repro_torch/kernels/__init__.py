"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``fused_query`` (PQ shortlist, f32 and int8 table),
``sparse_dot`` (exact rescore and brute force), ``scorer_mlp`` (pair
scorer), ``topk_select`` (graph merges and reads) and ``pq_score`` (the
unfused shortlist's table scoring). ``ops`` holds the entry points;
``_build`` compiles ``csrc/`` on first use."""
