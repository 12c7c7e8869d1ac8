"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``fused_query`` (PQ shortlist, f32 and int8 table),
``sparse_dot`` (the index's exact rescore with its final top-k, the
standalone rescore, brute force), ``scorer_mlp`` (pair features with the
scorer MLP, the standalone MLP), ``topk_select`` (graph merges and reads)
and ``pq_score`` (the unfused shortlist's table scoring). ``ops`` holds
the entry points; ``_build`` compiles ``csrc/`` on first use."""
