"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``fused_query`` (PQ shortlist), ``sparse_dot`` (exact rescore and
brute force) and ``scorer_mlp`` (pair scorer). ``ops`` holds the entry
points; ``_build`` compiles ``csrc/`` on first use."""
