"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7 interleave,
MoE 16e top-2 every other layer. [arXiv:2403.19887; hf]

Sub-quadratic (attention only every 8th layer) -> serves long_500k.
bf16 optimizer moments: fp32 moments for 398B params (3.2 TB) would not
fit a 256-chip v5e pod (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab_size=65536, head_dim=128,
    n_experts=16, moe_top_k=2, expert_d_ff=24576,
    attn_period=8, moe_period=2,
    ssm_d_state=16, ssm_conv=4, ssm_expand=2,
    moment_dtype="bfloat16",
    microbatches=16,
)
