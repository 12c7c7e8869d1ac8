"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=151936, head_dim=128,
    n_experts=60, n_shared_experts=4, moe_top_k=4, expert_d_ff=1408,
    rope_theta=1e6,
    microbatches=2,
)
