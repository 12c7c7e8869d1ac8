"""Family dispatch (port of ``repro/models/model.py``): one model API over
the architectures.

    api = build_model(cfg)
    params = api.init_params(seed, cfg, device)
    logits, aux = api.apply(params, cfg, batch)          # train/prefill
    cache = api.init_cache(cfg, batch_size, max_len, device)
    logits, cache = api.decode_step(params, cfg, batch, cache)

The dense, moe and vlm families run ``models/transformer.py``, ssm
``models/xlstm.py``, hybrid ``models/hybrid.py`` and encdec
``models/encdec.py`` (whose caller fills the cross-attention cache with
``encdec.encode_prefill`` before decoding).

``input_specs``, ``cache_specs`` and ``params_specs`` give the stand-ins
of a dry-run cell's inputs (``launch/dryrun.py``): tensors on the
``meta`` device, which have a shape and a dtype and no memory, where the
reference has ``jax.ShapeDtypeStruct``s.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, hybrid, transformer, xlstm


class ModelApi(NamedTuple):
    init_params: Callable
    apply: Callable
    features: Callable     # apply minus the lm_head
    init_cache: Callable
    decode_step: Callable


def build_model(cfg: ModelConfig) -> ModelApi:
    if cfg.family in ("dense", "moe", "vlm"):
        m = transformer
    elif cfg.family == "ssm":
        m = xlstm
    elif cfg.family == "hybrid":
        m = hybrid
    elif cfg.family == "encdec":
        m = encdec
    else:
        raise ValueError(f"unknown family {cfg.family}")
    return ModelApi(m.init_params, m.apply, m.features, m.init_cache,
                    m.decode_step)


# -------------------------------------------------------- input specs

def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device="meta") -> dict:
    """The model inputs of one (arch x shape) cell, as empty tensors on
    ``device`` (``meta``: shapes and dtypes only): tokens and labels
    [B, S] int32 for train and prefill (the vlm family adds
    ``patch_embeds`` [B, n_patches, d] and M-RoPE ``positions`` [B, S, 3],
    encdec its mel ``frames`` [B, n_frames, d]); one token [B] for
    decode, against a seq_len-deep cache (``cache_specs``)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def empty(size, dtype):
        return torch.empty(size, dtype=dtype, device=device)

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": empty((b, s), i32), "labels": empty((b, s), i32)}
        if cfg.family == "vlm":
            batch["patch_embeds"] = empty((b, cfg.n_patches, cfg.d_model),
                                          cfg.cdtype)
            batch["positions"] = empty((b, s, 3), i32)
        if cfg.family == "encdec":
            batch["frames"] = empty((b, cfg.n_frames, cfg.d_model),
                                    cfg.cdtype)
        return batch
    return {"tokens": empty((b,), i32)}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> Any:
    """The decode cache of a cell on the ``meta`` device (``init_cache``
    at the cell's batch and seq_len)."""
    return build_model(cfg).init_cache(cfg, shape.global_batch,
                                       shape.seq_len, "meta")


def params_specs(cfg: ModelConfig, seed: int = 0) -> Any:
    """The params tree on the ``meta`` device (``init_params``)."""
    return build_model(cfg).init_params(seed, cfg, "meta")
