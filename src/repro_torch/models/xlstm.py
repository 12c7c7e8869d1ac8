"""xLSTM LM assembly (port of ``repro/models/xlstm.py``): groups of
(period - 1) mLSTM blocks and one sLSTM block.

xLSTM[7:1]: one sLSTM every ``slstm_period`` layers. The mLSTM params are
stacked [groups, period - 1, ...] and the sLSTM's [groups, ...], as in the
reference; the layers run in Python loops over views of the stacks (the
reference's nested ``scan_stack``). In training each mLSTM and sLSTM
block is checkpointed where ``cfg.remat`` asks for it, as the reference's
are (the groups are not). No positional encodings (the recurrence
carries order).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.transformer import generator
from repro_torch.utils.device import resolve


def _groups(cfg) -> int:
    p = cfg.slstm_period
    if cfg.n_layers % p:
        raise ValueError("n_layers must divide by slstm_period")
    return cfg.n_layers // p


def init_params(seed: int, cfg, device=None) -> dict:
    """The reference's params tree, drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (the card unless the caller passes
    ``"cpu"``; ``"meta"`` gives the tree without memory)."""
    groups, p = _groups(cfg), cfg.slstm_period
    gen = generator(seed, device)
    return {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.pdtype),
        "mlstm": L.stack_draws(lambda: ssm.init_mlstm(gen, cfg),
                               (groups, p - 1)),
        "slstm": L.stack_draws(lambda: ssm.init_slstm(gen, cfg), (groups,)),
        "final_norm": L.full(gen, (cfg.d_model,), 1.0, torch.float32),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                cfg.pdtype),
    }


def features(params, cfg, batch):
    x = L.embed(params, batch["tokens"]).to(cfg.cdtype)
    mlstm = L.remat(lambda p, h: h + ssm.mlstm_train(p, cfg, h), cfg)
    slstm = L.remat(lambda p, h: ssm.slstm_train(p, cfg, h), cfg)
    for g in range(_groups(cfg)):
        for j in range(cfg.slstm_period - 1):
            x = mlstm(L.index(params["mlstm"], g, j), x)
        x = slstm(L.index(params["slstm"], g), x)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), 0.0


def apply(params, cfg, batch):
    x, aux = features(params, cfg, batch)
    logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"])
    return logits, aux


def init_cache(cfg, batch: int, max_len: int, device=None):
    """O(1) recurrent state (``max_len`` is unused) on ``device`` (the card
    unless the caller passes ``"cpu"``)."""
    device = resolve(device)
    groups, p = _groups(cfg), cfg.slstm_period
    return {
        "mlstm": L.tile(ssm.mlstm_cache(cfg, batch, device), (groups, p - 1)),
        "slstm": L.tile(ssm.slstm_cache(cfg, batch, device), (groups,)),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def decode_step(params, cfg, batch, cache):
    """One token for every sequence -> (logits [B, Vp] f32, cache). The
    states are updated in ``cache``'s tensors, in place."""
    x = params["embed"][batch["tokens"][:, None]].to(cfg.cdtype)
    for g in range(_groups(cfg)):
        for j in range(cfg.slstm_period - 1):
            delta, _ = ssm.mlstm_decode(L.index(params["mlstm"], g, j), cfg,
                                        x, L.index(cache["mlstm"], g, j))
            x = x + delta
        x, _ = ssm.slstm_decode(L.index(params["slstm"], g), cfg, x,
                                L.index(cache["slstm"], g))
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"])[:, 0]
    return logits.float(), {**cache, "len": cache["len"] + 1}
