"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution (stub frontend).
[arXiv:2409.12191; hf]

The vision tower is a STUB per the brief: input_specs() supplies
precomputed patch embeddings spliced into the first n_patches positions.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064, head_dim=128,
    n_patches=1024, mrope_sections=(16, 24, 24),
    rope_theta=1e6, use_bias=False,
    microbatches=2,
)
