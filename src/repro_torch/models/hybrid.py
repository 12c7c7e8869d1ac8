"""Jamba-style hybrid (port of ``repro/models/hybrid.py``): Mamba +
attention 1:7 interleave, MoE every second layer.

Layer pattern within each period-``attn_period`` group (global layer index
g * P + j):
    j == 0      : attention + dense MLP
    j odd       : mamba + MoE FFN
    j even > 0  : mamba + dense MLP

The params are stacked [groups, ...] (attention) and [groups, n, ...]
(the two kinds of mamba layer), as in the reference; the layers run in
Python loops over views. Attention layers carry KV caches (written in
place, clamped like ``dynamic_update_slice``), mamba layers O(1) conv and
SSM state (updated in place). Attention is NoPE: no rotary embedding. In
training each sub-layer is checkpointed where ``cfg.remat`` asks for it,
as the reference's are (the groups are not).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.models.transformer import (_attn_out, _project_qkv,
                                            generator, init_attn,
                                            init_dense_ffn, write_rows)
from repro_torch.utils.device import resolve


def _layout(cfg) -> tuple[int, int, int]:
    """(groups, MoE mamba layers a group, dense mamba layers a group)."""
    per = cfg.attn_period
    if cfg.n_layers % per:
        raise ValueError("n_layers must divide by attn_period")
    return cfg.n_layers // per, per // 2, per // 2 - 1


def _init_mamba_layer(gen, cfg, use_moe: bool) -> dict:
    p = {"mamba": ssm.init_mamba(gen, cfg),
         "ffn_norm": L.full(gen, (cfg.d_model,), 1.0, torch.float32)}
    if use_moe:
        p["moe"] = init_moe(gen, cfg)
    else:
        p.update(init_dense_ffn(gen, cfg))
    return p


def init_params(seed: int, cfg, device=None) -> dict:
    """The reference's params tree, drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (the card unless the caller passes
    ``"cpu"``; ``"meta"`` gives the tree without memory)."""
    groups, n_moe, n_md = _layout(cfg)
    gen = generator(seed, device)
    return {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.pdtype),
        "attn": L.stack_draws(lambda: {**init_attn(gen, cfg),
                                       **init_dense_ffn(gen, cfg)},
                              (groups,)),
        "mamba_moe": L.stack_draws(lambda: _init_mamba_layer(gen, cfg, True),
                                   (groups, n_moe)),
        "mamba_dense": L.stack_draws(
            lambda: _init_mamba_layer(gen, cfg, False), (groups, n_md)),
        "final_norm": L.full(gen, (cfg.d_model,), 1.0, torch.float32),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                cfg.pdtype),
    }


def _attn_train(p, cfg, x):
    h = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = _project_qkv(p, cfg, h)          # NoPE: no rotary applied
    if x.shape[1] > cfg.attn_chunk:
        ctx = L.flash_attention(q, k, v, causal=True, kv_chunk=cfg.attn_chunk)
    else:
        ctx = L.full_attention(q, k, v, causal=True)
    return _attn_out(p, cfg, ctx)


def _dense_ffn(p, cfg, x):
    h = L.rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    return L.swiglu(h, p["gate"], p["up"], p["down"])


def _moe_ffn(p, cfg, x):
    return moe_ffn(p["moe"], cfg, L.rms_norm(x, p["ffn_norm"], cfg.norm_eps))


def _mamba_layers(cfg):
    """(kind, index within its stack) of a group's mamba layers, in order:
    layer j of the group is MoE if j is odd."""
    for j in range(1, cfg.attn_period):
        yield ("mamba_moe", j // 2) if j % 2 else ("mamba_dense", j // 2 - 1)


def _attn_sub(p, cfg, x):
    x = x + _attn_train(p, cfg, x)
    return x + _dense_ffn(p, cfg, x)


def _mamba_moe_sub(p, cfg, x):
    x = x + ssm.mamba_train(p["mamba"], cfg, x)
    y, aux = _moe_ffn(p, cfg, x)
    return x + y, aux


def _mamba_dense_sub(p, cfg, x):
    x = x + ssm.mamba_train(p["mamba"], cfg, x)
    return x + _dense_ffn(p, cfg, x)


def _group_train(params, g: int, cfg, x):
    """One interleave group: the attention layer, then (P - 1) mamba
    layers, each sub-layer checkpointed in training where ``cfg.remat``
    asks for it (the reference's ``_group_train``). -> (x, the group's aux
    loss)."""
    x = L.remat(_attn_sub, cfg)(L.index(params["attn"], g), cfg, x)
    aux = 0.0
    for kind, i in _mamba_layers(cfg):
        lp = L.index(params[kind], g, i)
        if kind == "mamba_moe":
            x, a = L.remat(_mamba_moe_sub, cfg)(lp, cfg, x)
            aux = aux + a
        else:
            x = L.remat(_mamba_dense_sub, cfg)(lp, cfg, x)
    return x, aux


def features(params, cfg, batch):
    x = L.embed(params, batch["tokens"]).to(cfg.cdtype)
    aux = 0.0
    for g in range(_layout(cfg)[0]):
        x, a = _group_train(params, g, cfg, x)
        aux = aux + a
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def apply(params, cfg, batch):
    x, aux = features(params, cfg, batch)
    logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"])
    return logits, aux


def init_cache(cfg, batch: int, max_len: int, device=None):
    """KV caches [groups, B, Smax, Hkv, Dh] of the attention layers, the
    mamba layers' state stacked [groups, n, ...], lengths [B]; on
    ``device`` (the card unless the caller passes ``"cpu"``)."""
    device = resolve(device)
    groups, n_moe, n_md = _layout(cfg)
    kv = (groups, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    one = ssm.mamba_cache(cfg, batch, device)
    return {
        "k": torch.zeros(kv, dtype=cfg.cdtype, device=device),
        "v": torch.zeros(kv, dtype=cfg.cdtype, device=device),
        "mamba_moe": L.tile(one, (groups, n_moe)),
        "mamba_dense": L.tile(one, (groups, n_md)),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def decode_step(params, cfg, batch, cache):
    """One token for every sequence -> (logits [B, Vp] f32, cache); the
    caches are written in place."""
    x = params["embed"][batch["tokens"][:, None]].to(cfg.cdtype)
    cache_len = cache["len"]
    for g in range(_layout(cfg)[0]):
        ap = L.index(params["attn"], g)
        kc, vc = cache["k"][g], cache["v"][g]
        # the attention layer (NoPE)
        hn = L.rms_norm(x, ap["attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(ap, cfg, hn)
        write_rows(kc, k, cache_len)
        write_rows(vc, v, cache_len)
        ctx = L.decode_attention(q, kc, vc, cache_len + 1)
        x = x + _attn_out(ap, cfg, ctx)
        x = x + _dense_ffn(ap, cfg, x)
        for kind, i in _mamba_layers(cfg):
            lp = L.index(params[kind], g, i)
            delta, _ = ssm.mamba_decode(lp["mamba"], cfg, x,
                                        L.index(cache[kind], g, i))
            x = x + delta
            if kind == "mamba_moe":
                x = x + _moe_ffn(lp, cfg, x)[0]
            else:
                x = x + _dense_ffn(lp, cfg, x)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"])[:, 0]
    return logits.float(), {**cache, "len": cache["len"] + 1}
