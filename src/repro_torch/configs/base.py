"""Model + input-shape configuration system (port of
``repro/configs/base.py``).

One ``ModelConfig`` per assigned architecture (see configs/<arch>.py); the
four assigned input shapes are global ``ShapeConfig``s. Configs are frozen
dataclasses, hashable and overridable via ``dataclasses.replace``; every
field and default is the reference's, so ``dataclasses.asdict`` of a port
config equals the reference's. ``pdtype`` / ``cdtype`` are torch dtypes.
The mesh and program-structure fields (``dp_axes``, ``sp_axis``,
``model_axis_size``, ``microbatches``, ``scan_layers``, ``remat``) are
carried for the training and sharding slices; the serving path reads none
of them.
"""
from __future__ import annotations

import dataclasses

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                  # dense | moe | vlm | ssm | encdec | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qk_norm: bool = False
    use_bias: bool = False
    rope_theta: float = 1e6
    # --- MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    expert_d_ff: int = 0         # routed-expert hidden dim (0 -> d_ff)
    capacity_factor: float = 1.25
    # --- SSM / xLSTM
    ssm_d_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    slstm_period: int = 0        # xlstm: one sLSTM every `period` layers
    mlstm_chunk: int = 0         # chunkwise mLSTM when seq > chunk (0=off)
    # --- hybrid (jamba)
    attn_period: int = 0         # one attention layer every `period`
    moe_period: int = 0          # MoE FFN every `period` layers
    # --- enc-dec (whisper)
    n_enc_layers: int = 0
    n_frames: int = 1500         # stub frontend: precomputed mel frames
    # --- VLM (qwen2-vl)
    n_patches: int = 0           # stub frontend: precomputed patch embeds
    mrope_sections: tuple = ()
    # --- numerics & program structure
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    vocab_pad_multiple: int = 128
    scan_layers: bool = True
    remat: bool = True
    attn_chunk: int = 2048       # flash-attention KV chunk for long seqs
    norm_eps: float = 1e-6
    moment_dtype: str = "float32"  # bf16 for the >=100B configs
    # data-parallel mesh axes for activation sharding constraints; () = no
    # constraints (single-device tests). The launcher sets this per mesh —
    # without the anchor, GSPMD can propagate a feature-dim sharding from
    # the embed table into every activation and replicate the batch.
    dp_axes: tuple = ()
    # sequence-parallel axis for the block-boundary activations (Megatron
    # SP): the scan-saved per-layer carries shard on seq over "model",
    # cutting saved-activation memory by the TP degree. "" disables.
    sp_axis: str = ""
    # model-axis size, set by the launcher: lets layer code apply
    # divisibility-guarded channel/expert sharding constraints.
    model_axis_size: int = 0
    # gradient-accumulation microbatches per train step: bounds live
    # activation memory at the giant configs (grads accumulate in the
    # param dtype, sharded like the params).
    microbatches: int = 1

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_groups(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    @property
    def pdtype(self):
        return DTYPES[self.param_dtype]

    @property
    def cdtype(self):
        return DTYPES[self.compute_dtype]

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can serve 500k-token contexts (SSM/hybrid)."""
        return self.family in ("ssm", "hybrid")

    def expert_ff(self) -> int:
        return self.expert_d_ff or self.d_ff


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is (arch x shape) a live dry-run cell? (DESIGN.md §4 skips.)"""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 500k-token decode needs "
                       "sub-quadratic attention (skip per brief)")
    return True, ""
