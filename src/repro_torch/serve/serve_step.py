"""Serving step factories for the model tower (port of
``repro/serve/serve_step.py``): prefill and decode.

``decode_step`` is the program the reference's dry-run lowers for its
``decode_32k`` cells: one new token for every sequence against a
seq_len-deep cache. Sampling is greedy (``argmax``, the lowest index on
ties) or temperature/top-k with an explicit ``torch.Generator`` where the
reference takes a PRNG key; the draw is Gumbel-max, the distribution of
``jax.random.categorical``. Both steps run under ``torch.inference_mode``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import build_model


def make_prefill_step(cfg: ModelConfig):
    api = build_model(cfg)

    @torch.inference_mode()
    def prefill_step(params, batch):
        logits, _ = api.apply(params, cfg, batch)
        return logits

    return prefill_step


def make_decode_step(cfg: ModelConfig, temperature: float = 0.0,
                     top_k: int = 0):
    api = build_model(cfg)

    @torch.inference_mode()
    def decode_step(params, cache, tokens, key=None):
        logits, cache = api.decode_step(params, cfg, {"tokens": tokens}, cache)
        logits = logits[..., :cfg.vocab_size]
        if temperature <= 0.0:
            next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            scaled = logits / temperature
            if top_k:
                kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
                scaled = torch.where(scaled < kth, -torch.inf, scaled)
            u = torch.rand(scaled.shape, generator=key, device=scaled.device)
            u = u.clamp_min(torch.finfo(torch.float32).tiny)
            gumbel = -torch.log(-torch.log(u))
            next_tok = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
        return next_tok, logits, cache

    return decode_step
