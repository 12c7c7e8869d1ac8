"""Decoder-only transformer of the dense, moe and vlm families (port of
``repro/models/transformer.py``).

One implementation, config-driven: GQA (+ optional qk_norm), RoPE or
M-RoPE (vlm), swiglu FFN or MoE FFN (``models/moe.py``), optional biases.
The params dict has the reference's keys and layout: blocks are stacked
[L, ...], and the layers run in a Python loop over ``params["blocks"]``
views. In training each layer is checkpointed where ``cfg.remat`` asks
for it, as the reference's ``scan_stack`` is (``layers.remat``).

Entry points, as in the reference:
  apply(params, cfg, batch)                 -> (logits, aux)   # teacher-forced
  prefill(params, cfg, batch, cache)        -> (logits, aux)   # = apply
  decode_step(params, cfg, batch, cache)    -> (logits, cache) # one token

``decode_step`` writes the new K/V rows into ``cache``'s tensors in place
and returns a new dict over them (the reference returns fresh arrays):
a caller that keeps the old dict sees the rows written.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.utils.device import resolve


# ------------------------------------------------------------------- init

def init_attn(gen, cfg) -> dict:
    """The attention's params and both pre-norms (those of a dense layer
    without its FFN), drawn from ``gen`` on its device."""
    d, hkv, dh = cfg.d_model, cfg.n_kv_heads, cfg.head_dim_
    h = cfg.n_heads
    f32 = torch.float32
    p = {
        "attn_norm": L.full(gen, (d,), 1.0, f32),
        "wq": L.dense_init(gen, d, h * dh, cfg.pdtype).reshape(d, h, dh),
        "wk": L.dense_init(gen, d, hkv * dh, cfg.pdtype).reshape(d, hkv, dh),
        "wv": L.dense_init(gen, d, hkv * dh, cfg.pdtype).reshape(d, hkv, dh),
        "wo": L.dense_init(gen, h * dh, d, cfg.pdtype).reshape(h, dh, d),
        "ffn_norm": L.full(gen, (d,), 1.0, f32),
    }
    if cfg.qk_norm:
        p["q_norm"] = L.full(gen, (dh,), 1.0, f32)
        p["k_norm"] = L.full(gen, (dh,), 1.0, f32)
    if cfg.use_bias:
        p["bq"] = L.full(gen, (h, dh), 0.0, cfg.pdtype)
        p["bk"] = L.full(gen, (hkv, dh), 0.0, cfg.pdtype)
        p["bv"] = L.full(gen, (hkv, dh), 0.0, cfg.pdtype)
        p["bo"] = L.full(gen, (d,), 0.0, cfg.pdtype)
    return p


def init_dense_ffn(gen, cfg) -> dict:
    return {"gate": L.dense_init(gen, cfg.d_model, cfg.d_ff, cfg.pdtype),
            "up": L.dense_init(gen, cfg.d_model, cfg.d_ff, cfg.pdtype),
            "down": L.dense_init(gen, cfg.d_ff, cfg.d_model, cfg.pdtype)}


def init_block(gen, cfg) -> dict:
    """One layer's params, drawn from ``gen`` on its device."""
    p = init_attn(gen, cfg)
    if cfg.family == "moe":
        p["moe"] = init_moe(gen, cfg)
    else:
        p.update(init_dense_ffn(gen, cfg))
    return p


def generator(seed: int, device=None) -> torch.Generator | None:
    """A generator seeded with ``seed`` on ``device`` (the card unless the
    caller passes ``"cpu"``); ``None`` on ``meta``, where the inits make
    empty tensors."""
    dev = resolve(device)
    return None if dev.type == "meta" else torch.Generator(dev).manual_seed(
        seed)


def init_params(seed: int, cfg, device=None) -> dict:
    """The reference's params tree at ``cfg``'s shapes, dtypes and scales,
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (the card unless the caller passes ``"cpu"``; ``"meta"`` gives the
    tree without memory). Each layer is drawn in f32 and cast into its
    slot of the stacked [L, ...] tensors, so the largest f32 temporary is
    one tensor (the embed at full width), never a copy of the model."""
    gen = generator(seed, device)
    blocks = L.stack_draws(lambda: init_block(gen, cfg), (cfg.n_layers,))
    return {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.pdtype),
        "blocks": blocks,
        "final_norm": L.full(gen, (cfg.d_model,), 1.0, torch.float32),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                cfg.pdtype),
    }


def layer(params, i: int) -> dict:
    """Layer ``i``'s params: views into the stacked blocks."""
    return L.index(params["blocks"], i)


# -------------------------------------------------------------- attention

def _project_qkv(p, cfg, h):
    b, s, _ = h.shape
    hkv, g, dh = cfg.n_kv_heads, cfg.q_groups, cfg.head_dim_
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
    if cfg.use_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = q.reshape(b, s, hkv, g, dh)
    return q, k, v


def _attn_out(p, cfg, ctx):
    b, s = ctx.shape[:2]
    ctx = ctx.reshape(b, s, cfg.n_heads, cfg.head_dim_)
    out = torch.einsum("bshk,hkd->bsd", ctx, p["wo"])
    if cfg.use_bias:
        out = out + p["bo"]
    return out


def attention_train(p, cfg, x, cos, sin):
    h = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = _project_qkv(p, cfg, h)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    s = x.shape[1]
    if s > cfg.attn_chunk:
        ctx = L.flash_attention(q, k, v, causal=True, kv_chunk=cfg.attn_chunk)
    else:
        ctx = L.full_attention(q, k, v, causal=True)
    return _attn_out(p, cfg, ctx)


def attention_decode(p, cfg, x, cos, sin, k_cache, v_cache, cache_len):
    """x [B,1,d]; caches [B,Smax,Hkv,Dh]; returns (out, k_cache, v_cache).
    The new row goes to each sample's ``cache_len``, clamped to the last
    row as the reference's ``dynamic_update_slice`` clamps its start; the
    caches are written in place."""
    h = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = _project_qkv(p, cfg, h)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    write_rows(k_cache, k, cache_len)
    write_rows(v_cache, v, cache_len)
    ctx = L.decode_attention(q, k_cache, v_cache, cache_len + 1)
    return _attn_out(p, cfg, ctx), k_cache, v_cache


def write_rows(cache, new, cache_len) -> None:
    """``new`` [B, 1, ...] into ``cache`` [B, Smax, ...] at each sample's
    ``cache_len``, in place, clamped to the last row as the reference's
    ``dynamic_update_slice`` clamps its start."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = torch.clamp(cache_len, max=cache.shape[1] - 1)
    cache[rows, at] = new[:, 0].to(cache.dtype)


# ------------------------------------------------------------------ block

def _ffn(p, cfg, x):
    h = L.rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    if cfg.family == "moe":
        return moe_ffn(p["moe"], cfg, h)
    return L.swiglu(h, p["gate"], p["up"], p["down"]), 0.0


def block_train(p, cfg, x, cos, sin):
    x = x + attention_train(p, cfg, x, cos, sin)
    y, aux = _ffn(p, cfg, x)
    return x + y, aux


def block_decode(p, cfg, x, cos, sin, k_cache, v_cache, cache_len):
    a, k_cache, v_cache = attention_decode(p, cfg, x, cos, sin,
                                           k_cache, v_cache, cache_len)
    x = x + a
    y, aux = _ffn(p, cfg, x)
    return x + y, k_cache, v_cache


# ------------------------------------------------------------- embeddings

def _positions_cos_sin(cfg, positions):
    """positions int [B,S] (or [B,S,3] for vlm M-RoPE) -> cos/sin."""
    if cfg.family == "vlm":
        return L.mrope_cos_sin(positions, cfg.head_dim_, cfg.mrope_sections,
                               cfg.rope_theta)
    return L.rope_cos_sin(positions, cfg.head_dim_, cfg.rope_theta)


def _embed(params, cfg, batch):
    x = L.embed(params, batch["tokens"]).to(cfg.cdtype)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        # stub frontend: precomputed patch embeddings occupy the first
        # n_patches positions (the modality frontend is a stub)
        pe = batch["patch_embeds"].to(cfg.cdtype)
        n = min(pe.shape[1], x.shape[1])
        x = torch.cat([pe[:, :n], x[:, n:]], dim=1)
    return x


# ---------------------------------------------------------------- forward

def features(params, cfg, batch):
    """Teacher-forced forward up to the final norm: -> (x [B,S,d], aux).
    The lm_head projection is left to the caller."""
    positions = batch.get("positions")
    tokens = batch["tokens"]
    if positions is None:
        s = tokens.shape[1]
        positions = torch.arange(s, device=tokens.device).expand(
            tokens.shape[:2])
        if cfg.family == "vlm":
            positions = positions[..., None].expand(*positions.shape, 3)
    cos, sin = _positions_cos_sin(cfg, positions)
    x = _embed(params, cfg, batch)
    aux = 0.0
    block = L.remat(block_train, cfg)
    for i in range(cfg.n_layers):
        x, aux_i = block(layer(params, i), cfg, x, cos, sin)
        aux = aux + aux_i
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def apply(params, cfg, batch):
    """(logits [B,S,Vp] in compute dtype, aux_loss)."""
    x, aux = features(params, cfg, batch)
    logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"])
    return logits, aux


def init_cache(cfg, batch: int, max_len: int, device=None):
    """Per-layer KV caches stacked [L, B, Smax, Hkv, Dh] + lengths [B], on
    ``device`` (the card unless the caller passes ``"cpu"``)."""
    device = resolve(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return {
        "k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.cdtype, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def decode_step(params, cfg, batch, cache):
    """One token for every sequence: batch {tokens [B]} + cache ->
    (logits [B, Vp] f32, cache)."""
    b = batch["tokens"].shape[0]
    tokens = batch["tokens"][:, None]                        # [B, 1]
    positions = cache["len"][:, None]                        # [B, 1]
    if cfg.family == "vlm":
        positions = positions[..., None].expand(b, 1, 3)
    cos, sin = _positions_cos_sin(cfg, positions)
    x = params["embed"][tokens].to(cfg.cdtype)
    for i in range(cfg.n_layers):
        x, _, _ = block_decode(layer(params, i), cfg, x, cos, sin,
                               cache["k"][i], cache["v"][i], cache["len"])
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"])[:, 0]
    new_cache = {"k": cache["k"], "v": cache["v"], "len": cache["len"] + 1}
    return logits.float(), new_cache


def prefill(params, cfg, batch, cache):
    """The reference's prefill: ``apply``'s logits; the cache is not
    filled (the reference does not fill it either)."""
    logits, aux = apply(params, cfg, batch)
    return logits, aux
