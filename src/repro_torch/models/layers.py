"""Shared model layers (port of ``repro/models/layers.py``): norms, RoPE /
M-RoPE, GQA attention (full + chunked flash form), MLPs. Everything is a
plain function over tensors and plain dict params.

Conventions, as in the reference:
* activations run in ``cfg.compute_dtype`` (bf16 on the card), softmax and
  norms accumulate in f32;
* attention is grouped-query throughout — q is [B, S, Hkv, G, Dh] against
  k/v [B, S, Hkv, Dh], so KV replication is never materialized;
* attention scores and flash's ``p @ v`` come out in f32 (the reference's
  ``preferred_element_type=f32``): both operands are up-cast before the
  product, which is exact for bf16 inputs and accumulates in f32;
* ``flash_attention`` is the O(L)-memory chunked form (online softmax over
  KV blocks), a Python loop over the chunks where the reference scans.

The reference's sharding anchors (``constrain_act``,
``constrain_channels``) and its layer-stack loop (``scan_stack``) have no
meaning in one torch process and are not here; the models run their
stacked layers in Python loops over views (``stack_draws`` builds the
stacks, ``index`` takes one layer's views). They belong to the sharding
slice (ROADMAP.md Queue 1 item 5.4).

Training: where autograd records, ``index`` takes a stacked param's layer
through ``_TakeLayer``, whose backward adds the layer's gradient into its
slot of the stacked param's ``.grad`` in place (one gradient tree, each
layer's gradient written as it is produced; a plain ``select`` would
make a zero [L, ...] tensor a layer), and ``remat`` wraps a function in
``torch.utils.checkpoint`` where the reference places ``jax.checkpoint``
and ``cfg.remat`` asks for it. Under ``torch.inference_mode`` (serving)
neither does anything.

Every init draws from a ``torch.Generator`` on its device; with no
generator (``gen=None``) it makes empty tensors on the ``meta`` device:
the params tree's shapes and dtypes without memory (``convert.lm_params``
takes its template so).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# ----------------------------------------------------------------- init

META = torch.device("meta")


def gen_device(gen: torch.Generator | None) -> torch.device:
    """Where ``gen`` draws: its device, or ``meta`` without a generator."""
    return META if gen is None else gen.device


def normal(gen, shape) -> torch.Tensor:
    """Standard normal f32 draws on ``gen``'s device (empty on ``meta``
    without a generator)."""
    if gen is None:
        return torch.empty(shape, dtype=torch.float32, device=META)
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def uniform(gen, shape, lo: float, hi: float) -> torch.Tensor:
    """U(lo, hi) f32 draws on ``gen``'s device (empty on ``meta`` without
    a generator)."""
    if gen is None:
        return torch.empty(shape, dtype=torch.float32, device=META)
    return torch.rand(shape, generator=gen, device=gen.device,
                      dtype=torch.float32) * (hi - lo) + lo


def full(gen, shape, value: float, dtype) -> torch.Tensor:
    """A constant tensor on ``gen``'s device (norm scales, biases)."""
    return torch.full(shape, value, dtype=dtype, device=gen_device(gen))


def dense_init(gen: torch.Generator | None, d_in, d_out, dtype,
               scale: float | None = None):
    """[d_in, d_out] normal * ``scale`` (default ``d_in ** -0.5``), drawn in
    f32 on ``gen``'s device, then cast to ``dtype``."""
    scale = (1.0 / d_in) ** 0.5 if scale is None else scale
    return (normal(gen, (d_in, d_out)) * scale).to(dtype)


def embed_init(gen: torch.Generator | None, vocab, d, dtype):
    return (normal(gen, (vocab, d)) * 0.02).to(dtype)


def _put(dst: dict, src: dict, at) -> None:
    for name, t in src.items():
        if isinstance(t, dict):
            _put(dst[name], t, at)
        else:
            dst[name][at] = t


def stack_draws(draw, lead: tuple) -> dict:
    """The reference's stacked params: ``draw()`` (one layer's params
    tree) called once per index of ``lead`` and each tree cast into its
    slot of [*lead, ...] tensors, allocated at the first draw, so the
    largest temporary is one layer, never a copy of the stack."""
    out = None
    for at in np.ndindex(*lead):
        one = draw()
        if out is None:
            out = map_tree(lambda t: torch.empty(
                (*lead, *t.shape), dtype=t.dtype, device=t.device), one)
        _put(out, one, at)
        del one
    return out


def map_tree(fn, tree):
    """``fn`` over every tensor of a nested dict."""
    return {name: (map_tree(fn, t) if isinstance(t, dict) else fn(t))
            for name, t in tree.items()}


def tile(tree: dict, lead: tuple) -> dict:
    """Copies of every tensor of a tree (one layer's state), stacked
    [*lead, ...]."""
    return map_tree(lambda t: t.expand(*lead, *t.shape).clone(), tree)


class _TakeLayer(torch.autograd.Function):
    """``stacked[at]`` whose backward adds the layer's gradient into
    ``stacked.grad[at]`` in place (allocating a zero ``.grad`` the first
    time) and passes none on: the stacked param gets its gradient slot by
    slot, with no [L, ...] temporary."""

    @staticmethod
    def forward(ctx, stacked, at):
        ctx.stacked, ctx.at = stacked, at
        return stacked[at]

    @staticmethod
    def backward(ctx, grad):
        stacked = ctx.stacked
        if stacked.grad is None:
            stacked.grad = torch.zeros_like(stacked)
        stacked.grad[ctx.at].add_(grad)
        return None, None


def index(tree: dict, *at) -> dict:
    """The views ``t[at]`` of every tensor of a stacked tree: one layer's
    params or state, sharing memory with the stack (through
    ``_TakeLayer`` where autograd records and ``t`` requires grad)."""
    def take(t):
        if torch.is_grad_enabled() and t.requires_grad:
            return _TakeLayer.apply(t, at)
        return t[at]
    return map_tree(take, tree)


def remat(fn, cfg=None):
    """``fn`` under ``torch.utils.checkpoint`` (its activations recomputed
    in the backward) where autograd records and ``cfg.remat`` asks for it
    (``cfg=None``: always, as the reference's unconditional checkpoints);
    else ``fn`` itself."""
    if not torch.is_grad_enabled() or (cfg is not None and not cfg.remat):
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


# ------------------------------------------------------------- embedding

def embed(params, tokens):
    """The rows of ``params["embed"]`` at ``tokens`` (the teacher-forced
    forms' lookup). ``F.embedding``'s backward sums each row's gradients
    in a fixed order, where indexing's (an accumulating ``index_put_``)
    adds them in a thread-dependent order on the CPU: a resumed run must
    repeat an unbroken one bit for bit."""
    return F.embedding(tokens, params["embed"])


# ----------------------------------------------------------------- norms

def rms_norm(x, weight, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


# ------------------------------------------------------------------ rope

def rope_freqs(head_dim: int, theta: float = 1e4,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_cos_sin(positions, head_dim: int, theta: float = 1e4):
    """positions [.., S] int -> cos/sin [.., S, head_dim//2] f32."""
    ang = positions.float()[..., None] * rope_freqs(head_dim, theta,
                                                    positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [B, S, ..., Dh]; cos/sin [B, S, Dh//2] broadcast over head dims.
    Half-split rotation (the first half against the second), not
    interleaved pairs."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    # insert singleton head dims so cos/sin broadcast against x[..., Dh//2]
    for _ in range(x.ndim - cos.ndim):
        cos, sin = cos[..., None, :], sin[..., None, :]
    c = cos.float()
    s = sin.float()
    x1f, x2f = x1.float(), x2.float()
    return torch.cat([x1f * c - x2f * s, x2f * c + x1f * s],
                     dim=-1).to(x.dtype)


def mrope_cos_sin(positions3, head_dim: int, sections: tuple,
                  theta: float = 1e4):
    """Qwen2-VL multimodal RoPE: positions3 [B, S, 3] (t, h, w) with the
    rotary spectrum split into per-axis sections (|sections| = 3, summing
    to head_dim//2). Text tokens use t = h = w = position."""
    freqs = rope_freqs(head_dim, theta, positions3.device)   # [Dh/2]
    ang_axes = positions3.float()[..., None] \
        * freqs[None, None, None, :]                          # [B, S, 3, Dh/2]
    # frequency j takes its angle from axis sec_ids[j]
    sec_ids = torch.as_tensor(np.repeat(np.arange(3), np.asarray(sections)),
                              device=positions3.device)      # [Dh/2] in {0,1,2}
    cols = torch.arange(sec_ids.shape[0], device=positions3.device)
    ang = ang_axes[:, :, sec_ids, cols]                       # [B, S, Dh/2]
    return torch.cos(ang), torch.sin(ang)


# ------------------------------------------------------------- attention

NEG_INF = -1e30


def _gqa_scores(q, k, scale):
    # q [B,Sq,Hkv,G,Dh], k [B,Sk,Hkv,Dh] -> [B,Hkv,G,Sq,Sk] f32
    return torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale


def full_attention(q, k, v, *, causal: bool, q_offset=0):
    """Quadratic GQA attention. q [B,Sq,Hkv,G,Dh]; k,v [B,Sk,Hkv,Dh]."""
    scale = q.shape[-1] ** -0.5
    scores = _gqa_scores(q, k, scale)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qpos = torch.arange(sq, device=q.device) + q_offset
        mask = qpos[:, None] >= torch.arange(sk, device=q.device)[None, :]
        scores = torch.where(mask[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v)


def flash_attention(q, k, v, *, causal: bool, kv_chunk: int = 1024):
    """Chunked online-softmax attention — O(Sk/kv_chunk) memory.

    Loops over KV chunks carrying (m, l, acc); exact same math as
    full_attention. A key length that is not a multiple of ``kv_chunk``
    is zero-padded and the padding masked."""
    b, sq, hkv, g, dh = q.shape
    sk = k.shape[1]
    if sk % kv_chunk:
        pad = -sk % kv_chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_valid = torch.arange(sk + pad, device=q.device) < sk
        sk += pad
    else:
        kv_valid = torch.ones((sk,), dtype=torch.bool, device=q.device)
    scale = dh ** -0.5
    n_chunks = sk // kv_chunk
    qpos = torch.arange(sq, device=q.device)
    q32 = q.float()

    def step(m, l, acc, kc, vc, valid, lo):
        s = torch.einsum("bqhgd,bkhd->bhgqk", q32, kc.float()) * scale
        kpos = lo + torch.arange(kv_chunk, device=q.device)
        mask = valid[None, :]
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])
        s = torch.where(mask[None, None, None], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(q.dtype).float(),
                          vc.float())
        return m_new, l, acc * corr[..., None] + pv

    # the chunk body is checkpointed, as the reference's: without it the
    # backward keeps every chunk's probabilities, the whole Sq x Sk matrix
    step = remat(step)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dh), dtype=torch.float32,
                      device=q.device)
    for c_idx in range(n_chunks):
        lo = c_idx * kv_chunk
        m, l, acc = step(m, l, acc, k[:, lo:lo + kv_chunk],
                         v[:, lo:lo + kv_chunk], kv_valid[lo:lo + kv_chunk],
                         lo)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)  # [B,Sq,Hkv,G,Dh]


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-token decode: q [B,1,Hkv,G,Dh] vs cache [B,Smax,Hkv,Dh].

    Entries past ``cache_len`` are masked; softmax is over the full padded
    cache, as in the reference (whose compiled shape is static)."""
    scale = q.shape[-1] ** -0.5
    s = _gqa_scores(q, k_cache, scale)                       # [B,Hkv,G,1,Smax]
    smax = k_cache.shape[1]
    mask = (torch.arange(smax, device=q.device)[None, :]
            < cache_len[:, None])                            # [B, Smax]
    s = torch.where(mask[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache)


# ------------------------------------------------------------------ mlps

def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x, w_up, b_up, w_down, b_down):
    return F.gelu(x @ w_up + b_up, approximate="tanh") @ w_down + b_down
