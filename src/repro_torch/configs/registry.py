"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (command_r_plus_104b, granite_34b,
                           jamba_1_5_large_398b, phi3_5_moe_42b_a6_6b,
                           qwen2_moe_a2_7b, qwen2_vl_7b, qwen3_32b, qwen3_8b,
                           whisper_tiny, xlstm_1_3b)
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.arch_id: m.CONFIG
    for m in (qwen2_moe_a2_7b, phi3_5_moe_42b_a6_6b, granite_34b, qwen3_8b,
              command_r_plus_104b, qwen3_32b, qwen2_vl_7b, xlstm_1_3b,
              whisper_tiny, jamba_1_5_large_398b)
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def reduced_config(arch_id: str) -> ModelConfig:
    """Same family/topology, laptop-size: used by the per-arch smoke tests.

    Keeps every structural trait (GQA ratio, qk_norm, MoE top-k + shared
    experts, sLSTM/attention periods, enc-dec split, M-RoPE sections) while
    shrinking width/depth/vocab.
    """
    cfg = get_config(arch_id)
    n_layers = max(cfg.attn_period, cfg.slstm_period, 2)
    if cfg.family == "hybrid":
        n_layers = cfg.attn_period  # one full interleave group
    # preserve the GQA ratio at reduced head counts
    kv = min(cfg.n_kv_heads, 2)
    heads = kv * min(cfg.q_groups, 4)
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=128,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        expert_d_ff=0 if cfg.expert_d_ff == 0 else 128,
        n_experts=min(cfg.n_experts, 8),
        n_shared_experts=min(cfg.n_shared_experts, 2),
        vocab_size=512,
        vocab_pad_multiple=64,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        n_frames=64,
        n_patches=min(cfg.n_patches, 16) if cfg.n_patches else 0,
        mrope_sections=(4, 6, 6) if cfg.mrope_sections else (),
        param_dtype="float32", compute_dtype="float32",
        moment_dtype="float32",
        attn_chunk=64,
        microbatches=1,
        mlstm_chunk=0,
    )
