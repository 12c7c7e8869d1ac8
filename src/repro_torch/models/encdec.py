"""Whisper-style encoder-decoder backbone (port of
``repro/models/encdec.py``; the conv frontend is a stub).

The encoder consumes precomputed mel-frame embeddings [B, n_frames,
d_model]. Whisper internals: LayerNorm + biases, GELU MLPs, absolute
(sinusoidal) positions; the decoder uses sinusoidal rather than learned
positions, as the reference does. The layers run in Python loops over
views of the stacked [L, ...] params.

Serving: ``init_cache`` makes the self-attention KV caches and the
cross-attention K/V [L, B, n_frames, Hkv, Dh]; ``encode_prefill`` runs the
encoder and fills the cross K/V in place; ``decode_step`` writes each new
self-attention row in place (clamped like ``dynamic_update_slice``).
In training each encoder and decoder layer is checkpointed where
``cfg.remat`` asks for it, as the reference's stacks are.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
from repro_torch.models.transformer import generator, write_rows
from repro_torch.utils.device import resolve


def _sinusoid(positions, d_model: int):
    """positions [.., S] -> [.., S, d] classic sin/cos table (f32)."""
    half = d_model // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                     / max(half - 1, 1))
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _init_attn(gen, cfg, prefix=""):
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    f32, pd = torch.float32, cfg.pdtype
    return {
        f"{prefix}norm_w": L.full(gen, (d,), 1.0, f32),
        f"{prefix}norm_b": L.full(gen, (d,), 0.0, f32),
        f"{prefix}wq": L.dense_init(gen, d, h * dh, pd).reshape(d, h, dh),
        f"{prefix}wk": L.dense_init(gen, d, hkv * dh, pd).reshape(d, hkv, dh),
        f"{prefix}wv": L.dense_init(gen, d, hkv * dh, pd).reshape(d, hkv, dh),
        f"{prefix}wo": L.dense_init(gen, h * dh, d, pd).reshape(h, dh, d),
        f"{prefix}bq": L.full(gen, (h, dh), 0.0, pd),
        f"{prefix}bk": L.full(gen, (hkv, dh), 0.0, pd),
        f"{prefix}bv": L.full(gen, (hkv, dh), 0.0, pd),
        f"{prefix}bo": L.full(gen, (d,), 0.0, pd),
    }


def _init_mlp(gen, cfg):
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "mlp_norm_w": L.full(gen, (d,), 1.0, torch.float32),
        "mlp_norm_b": L.full(gen, (d,), 0.0, torch.float32),
        "w_up": L.dense_init(gen, d, ff, cfg.pdtype),
        "b_up": L.full(gen, (ff,), 0.0, cfg.pdtype),
        "w_down": L.dense_init(gen, ff, d, cfg.pdtype),
        "b_down": L.full(gen, (d,), 0.0, cfg.pdtype),
    }


def init_params(seed: int, cfg, device=None) -> dict:
    """The reference's params tree, drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (the card unless the caller passes
    ``"cpu"``; ``"meta"`` gives the tree without memory)."""
    gen = generator(seed, device)
    d = cfg.d_model
    return {
        "embed": L.embed_init(gen, cfg.padded_vocab, d, cfg.pdtype),
        "enc": L.stack_draws(lambda: {**_init_attn(gen, cfg),
                                      **_init_mlp(gen, cfg)},
                             (cfg.n_enc_layers,)),
        "dec": L.stack_draws(lambda: {**_init_attn(gen, cfg),
                                      **_init_attn(gen, cfg, "x_"),
                                      **_init_mlp(gen, cfg)},
                             (cfg.n_layers,)),
        "enc_norm_w": L.full(gen, (d,), 1.0, torch.float32),
        "enc_norm_b": L.full(gen, (d,), 0.0, torch.float32),
        "final_norm_w": L.full(gen, (d,), 1.0, torch.float32),
        "final_norm_b": L.full(gen, (d,), 0.0, torch.float32),
        "lm_head": L.dense_init(gen, d, cfg.padded_vocab, cfg.pdtype),
    }


def _proj(x, p, name, prefix=""):
    """The biased head projection ``{prefix}w{name}`` of x [B,S,d]."""
    return torch.einsum("bsd,dhk->bshk", x, p[f"{prefix}w{name}"]) \
        + p[f"{prefix}b{name}"]


def _out(p, cfg, ctx, prefix=""):
    b, s = ctx.shape[:2]
    ctx = ctx.reshape(b, s, cfg.n_heads, cfg.head_dim_)
    return torch.einsum("bshk,hkd->bsd", ctx, p[f"{prefix}wo"]) \
        + p[f"{prefix}bo"]


def _attn(p, cfg, x, kv_src, *, causal, prefix=""):
    b, s, _ = x.shape
    hkv, g, dh = cfg.n_kv_heads, cfg.q_groups, cfg.head_dim_
    h = L.layer_norm(x, p[f"{prefix}norm_w"], p[f"{prefix}norm_b"])
    kv_in = h if kv_src is None else kv_src
    q = _proj(h, p, "q", prefix).reshape(b, s, hkv, g, dh)
    k, v = _proj(kv_in, p, "k", prefix), _proj(kv_in, p, "v", prefix)
    if s > cfg.attn_chunk or k.shape[1] > cfg.attn_chunk:
        ctx = L.flash_attention(q, k, v, causal=causal,
                                kv_chunk=cfg.attn_chunk)
    else:
        ctx = L.full_attention(q, k, v, causal=causal)
    return _out(p, cfg, ctx, prefix)


def _mlp(p, cfg, x):
    h = L.layer_norm(x, p["mlp_norm_w"], p["mlp_norm_b"])
    return L.gelu_mlp(h, p["w_up"], p["b_up"], p["w_down"], p["b_down"])


def encode(params, cfg, frames):
    """frames [B, n_frames, d] (the stub frontend's output) -> the
    encoder's states."""
    pos = torch.arange(frames.shape[1], device=frames.device)
    x = frames.to(cfg.cdtype) + _sinusoid(pos, cfg.d_model)[None].to(
        cfg.cdtype)
    layer = L.remat(_enc_layer, cfg)
    for i in range(cfg.n_enc_layers):
        x = layer(L.index(params["enc"], i), cfg, x)
    return L.layer_norm(x, params["enc_norm_w"], params["enc_norm_b"])


def _enc_layer(p, cfg, x):
    x = x + _attn(p, cfg, x, None, causal=False)
    return x + _mlp(p, cfg, x)


def _dec_layer(p, cfg, x, enc_out):
    x = x + _attn(p, cfg, x, None, causal=True)
    x = x + _attn(p, cfg, x, enc_out, causal=False, prefix="x_")
    return x + _mlp(p, cfg, x)


def features(params, cfg, batch):
    """batch {tokens [B,S], frames [B,F,d]} -> (decoder states, aux)."""
    enc_out = encode(params, cfg, batch["frames"])
    tokens = batch["tokens"]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = L.embed(params, tokens).to(cfg.cdtype) \
        + _sinusoid(pos, cfg.d_model)[None].to(cfg.cdtype)
    layer = L.remat(_dec_layer, cfg)
    for i in range(cfg.n_layers):
        x = layer(L.index(params["dec"], i), cfg, x, enc_out)
    return L.layer_norm(x, params["final_norm_w"],
                        params["final_norm_b"]), 0.0


def apply(params, cfg, batch):
    x, aux = features(params, cfg, batch)
    logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"])
    return logits, aux


def init_cache(cfg, batch: int, max_len: int, device=None):
    """Self-attention KV caches [L, B, Smax, Hkv, Dh], the cross K/V
    [L, B, n_frames, Hkv, Dh] (filled by ``encode_prefill``) and lengths
    [B], on ``device`` (the card unless the caller passes ``"cpu"``)."""
    device = resolve(device)
    dh, hkv = cfg.head_dim_, cfg.n_kv_heads
    shape = (cfg.n_layers, batch, max_len, hkv, dh)
    xshape = (cfg.n_layers, batch, cfg.n_frames, hkv, dh)
    z = lambda s: torch.zeros(s, dtype=cfg.cdtype, device=device)
    return {"k": z(shape), "v": z(shape), "xk": z(xshape), "xv": z(xshape),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def encode_prefill(params, cfg, frames, cache):
    """Run the encoder and fill every layer's cross-attention K/V in
    ``cache`` (in place); returns a new dict over the same tensors."""
    enc_out = encode(params, cfg, frames)
    for i in range(cfg.n_layers):
        lp = L.index(params["dec"], i)
        cache["xk"][i] = _proj(enc_out, lp, "k", "x_").to(cfg.cdtype)
        cache["xv"][i] = _proj(enc_out, lp, "v", "x_").to(cfg.cdtype)
    return dict(cache)


def decode_step(params, cfg, batch, cache):
    """One decoder token against the self-KV and the prefilled cross-KV
    caches -> (logits [B, Vp] f32, cache)."""
    b = batch["tokens"].shape[0]
    tokens = batch["tokens"][:, None]
    cache_len = cache["len"]
    x = params["embed"][tokens].to(cfg.cdtype) \
        + _sinusoid(cache_len[:, None], cfg.d_model).to(cfg.cdtype)
    hkv, g, dh = cfg.n_kv_heads, cfg.q_groups, cfg.head_dim_
    xlen = torch.full((b,), cfg.n_frames, dtype=torch.int32,
                      device=x.device)
    for i in range(cfg.n_layers):
        lp = L.index(params["dec"], i)
        kc, vc = cache["k"][i], cache["v"][i]
        # causal self-attention against the cache
        hn = L.layer_norm(x, lp["norm_w"], lp["norm_b"])
        q = _proj(hn, lp, "q").reshape(b, 1, hkv, g, dh)
        write_rows(kc, _proj(hn, lp, "k"), cache_len)
        write_rows(vc, _proj(hn, lp, "v"), cache_len)
        ctx = L.decode_attention(q, kc, vc, cache_len + 1)
        x = x + _out(lp, cfg, ctx)
        # cross-attention against the (prefilled) encoder K/V
        hn = L.layer_norm(x, lp["x_norm_w"], lp["x_norm_b"])
        q = _proj(hn, lp, "q", "x_").reshape(b, 1, hkv, g, dh)
        ctx = L.decode_attention(q, cache["xk"][i], cache["xv"][i], xlen)
        x = x + _out(lp, cfg, ctx, "x_")
        x = x + _mlp(lp, cfg, x)
    x = L.layer_norm(x, params["final_norm_w"], params["final_norm_b"])
    logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"])[:, 0]
    return logits.float(), {**cache, "len": cache["len"] + 1}
