"""whisper-tiny [audio] — enc-dec, conv frontend STUBBED.
[arXiv:2212.04356; unverified]

input_specs() supplies precomputed mel-frame embeddings (n_frames x
d_model) — the conv1d frontend is a stub per the brief. Whisper-style
internals: LayerNorm + biases + GELU MLP, absolute positions.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865, head_dim=64,
    n_enc_layers=4, n_frames=1500, use_bias=True,
)
