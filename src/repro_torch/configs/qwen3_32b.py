"""qwen3-32b [dense] — qk_norm, GQA, explicit head_dim=128.
[hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8,
    d_ff=25600, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6,
    microbatches=4,
)
