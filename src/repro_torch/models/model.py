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
``encdec.encode_prefill`` before decoding). The reference's
``input_specs``, ``cache_specs`` and ``params_specs`` are dry-run
machinery and come with ROADMAP.md Queue 1 item 5.4.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.configs.base import ModelConfig
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
