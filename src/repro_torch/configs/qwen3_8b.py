"""qwen3-8b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6,
    microbatches=2,
)
