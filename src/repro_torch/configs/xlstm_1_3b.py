"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks at 7:1 (one sLSTM per 8 layers).
[arXiv:2405.04517; unverified]

d_ff=0 per the assignment: xLSTM blocks carry their own up/down
projections (mLSTM pf=2 expansion, sLSTM gated 4/3 FFN), no separate
transformer FFN. Sub-quadratic -> serves the long_500k shape.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    slstm_period=8, ssm_expand=2,
    mlstm_chunk=1024,   # chunkwise-parallel mLSTM beyond 1k tokens (§Perf)
    microbatches=2,
)
