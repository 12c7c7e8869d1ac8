"""command-r-plus-104b [dense] — GQA, no-bias.
[hf:CohereForAI/c4ai-command-r-v01; unverified]

Adaptation note (DESIGN.md): Cohere's parallel attention+FFN residual is
modeled with the standard sequential pre-norm block; dims/heads/vocab match
the assignment exactly.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=33792, vocab_size=256000, head_dim=128,
    use_bias=False, rope_theta=75e4,
    microbatches=16,
)
