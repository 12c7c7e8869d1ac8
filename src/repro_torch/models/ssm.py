"""SSM-family blocks (port of ``repro/models/ssm.py``): Mamba (selective
scan) and xLSTM (mLSTM + sLSTM).

* Mamba's selective scan runs the recurrence one time step at a time (one
  fused multiply-add a step) over blocks of ``chunk`` steps whose gates
  are formed together: the working set is [B, chunk, dI, dS], and the
  result does not depend on ``chunk``. The reference runs an associative
  scan within each chunk; the two agree to f32 rounding. Serving writes
  each state into the chunk's buffer (``out=``); training, where an
  ``out=`` write cannot differentiate, stacks the chunk's states once.
* mLSTM runs in its stabilised parallel (quadratic) form, or chunkwise
  (a Python loop over chunks carrying the (C, n, m) matrix memory) past
  ``cfg.mlstm_chunk`` tokens, and decodes with the O(1) recurrence.
* sLSTM has true recurrent connections (R h_{t-1}) and runs as a Python
  loop over the tokens, a dozen small launches a token; the outputs are
  stacked once at the end (a write per token into one buffer would copy
  the whole gradient buffer per token in the backward).

The ``*_decode`` functions write the new state into the tensors of the
``cache`` dict they are given, in place, and return that dict: the mLSTM's
matrix memory is the largest state of the tower and is not copied. Every
cache is made on ``device`` (the card unless the caller passes "cpu").
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.utils.device import resolve

F32 = torch.float32


# ================================================================== Mamba

def dt_rank(cfg) -> int:
    return max(cfg.d_model // 16, 1)


def init_mamba(gen, cfg) -> dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    ds, conv, r = cfg.ssm_d_state, cfg.ssm_conv, dt_rank(cfg)
    dev = L.gen_device(gen)
    return {
        "norm": L.full(gen, (d,), 1.0, F32),
        "in_proj": L.dense_init(gen, d, 2 * di, cfg.pdtype),
        "conv_w": (L.normal(gen, (conv, di)) * (1 / conv) ** 0.5
                   ).to(cfg.pdtype),
        "conv_b": L.full(gen, (di,), 0.0, cfg.pdtype),
        "x_proj": L.dense_init(gen, di, r + 2 * ds, cfg.pdtype),
        "dt_proj": L.dense_init(gen, r, di, cfg.pdtype),
        # softplus^-1 of U(1e-3, 1e-1)
        "dt_bias": torch.log(torch.expm1(L.uniform(gen, (di,), 1e-3, 1e-1))),
        "A_log": torch.log(torch.arange(1, ds + 1, dtype=F32, device=dev)
                           .expand(di, ds).contiguous()),
        "D": L.full(gen, (di,), 1.0, F32),
        "out_proj": L.dense_init(gen, di, d, cfg.pdtype),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv over time. x [B,L,dI]; w [conv,dI]."""
    conv = w.shape[0]
    pad = F.pad(x, (0, 0, conv - 1, 0))
    out = torch.zeros_like(x)
    for j in range(conv):
        out = out + pad[:, j:j + x.shape[1]] * w[j]
    return out + b


def selective_scan(x, dt, a, bm, cm, chunk: int = 64):
    """h_t = exp(dt*A) h_{t-1} + dt*B_t*x_t ;  y_t = C_t . h_t.

    x, dt [B,L,dI]; a [dI,dS]; bm, cm [B,L,dS] -> y [B,L,dI] in x's dtype.
    The gates of ``chunk`` steps are formed at once ([B, chunk, dI, dS]
    f32, as the reference's chunk), then the state advances one step at a
    time; the result is the same for every ``chunk``."""
    b, l, di = x.shape
    h = torch.zeros((b, di, a.shape[-1]), dtype=F32, device=x.device)
    ys = []
    for lo in range(0, l, chunk):
        xc, dtc = x[:, lo:lo + chunk], dt[:, lo:lo + chunk]
        bc, cc = bm[:, lo:lo + chunk], cm[:, lo:lo + chunk]
        da = torch.exp(dtc.float()[..., None] * a)            # [b,c,di,ds]
        db = (dtc[..., None] * bc[:, :, None, :] * xc[..., None]).float()
        if da.requires_grad or db.requires_grad:
            # training: each state a tensor of its own, stacked once (an
            # ``out=`` write does not differentiate)
            hs = []
            for t in range(da.shape[1]):
                h = torch.addcmul(db[:, t], da[:, t], h)
                hs.append(h)
            hh = torch.stack(hs, dim=1)
        else:
            hh = torch.empty_like(da)
            for t in range(da.shape[1]):
                h = torch.addcmul(db[:, t], da[:, t], h, out=hh[:, t])
        y = torch.sum(hh * cc[:, :, None, :].float(), dim=-1)
        ys.append(y.to(x.dtype))
    return torch.cat(ys, dim=1)


def _dt(p, dt_in):
    """softplus(dt_in @ dt_proj + dt_bias), f32 (the bias is f32)."""
    return F.softplus(dt_in @ p["dt_proj"] + p["dt_bias"])


def mamba_train(p, cfg, x):
    """x [B,L,d] -> [B,L,d] (residual added by caller)."""
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    x_in, z = torch.chunk(h @ p["in_proj"], 2, dim=-1)
    x_c = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"]))
    r, ds = dt_rank(cfg), cfg.ssm_d_state
    dt_in, bm, cm = torch.split(x_c @ p["x_proj"], [r, ds, ds], dim=-1)
    dt = _dt(p, dt_in).to(x.dtype)
    a = -torch.exp(p["A_log"])
    y = selective_scan(x_c, dt, a, bm, cm)
    y = y + p["D"].to(x.dtype) * x_c
    return (y * F.silu(z)) @ p["out_proj"]


def mamba_cache(cfg, batch: int, device=None):
    device = resolve(device)
    di = cfg.ssm_expand * cfg.d_model
    return {"h": torch.zeros((batch, di, cfg.ssm_d_state), dtype=F32,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=F32,
                                device=device)}


def _conv_step(cache, x_in, w, b):
    """One step of the causal conv against the f32 history [B, conv-1, dI]
    (shifted in place): silu of the f32 sum, [B, dI]."""
    hist = torch.cat([cache["conv"], x_in[:, None].float()], dim=1)
    x_c = torch.sum(hist * w.float()[None], dim=1) + b.float()
    cache["conv"].copy_(hist[:, 1:])
    return F.silu(x_c)


def mamba_decode(p, cfg, x, cache):
    """x [B,1,d] + per-layer cache -> (out [B,1,d], cache updated in
    place)."""
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    x_in, z = torch.chunk(h @ p["in_proj"], 2, dim=-1)       # [B,1,dI]
    x_c = _conv_step(cache, x_in[:, 0], p["conv_w"], p["conv_b"]
                     ).to(x.dtype)                           # [B,dI]
    r, ds = dt_rank(cfg), cfg.ssm_d_state
    dt_in, bm, cm = torch.split(x_c @ p["x_proj"], [r, ds, ds], dim=-1)
    dt = _dt(p, dt_in)
    a = -torch.exp(p["A_log"])
    da = torch.exp(dt.float()[..., None] * a)               # [B,dI,dS]
    db = dt[..., None] * bm[:, None, :] * x_c[..., None]
    h_new = cache["h"].mul_(da).add_(db.float())
    y = torch.sum(h_new * cm[:, None, :].float(), dim=-1)
    y = (y + p["D"] * x_c.float()).to(x.dtype)
    out = ((y * F.silu(z[:, 0])) @ p["out_proj"])[:, None]
    return out, cache


# ================================================================== mLSTM

def init_mlstm(gen, cfg) -> dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    h = cfg.n_heads
    dh = di // h

    def blk():
        return (L.normal(gen, (h, dh, dh)) * (1 / dh) ** 0.5).to(cfg.pdtype)

    return {
        "norm": L.full(gen, (d,), 1.0, F32),
        "up_proj": L.dense_init(gen, d, 2 * di, cfg.pdtype),
        "conv_w": (L.normal(gen, (4, di)) * 0.5).to(cfg.pdtype),
        "conv_b": L.full(gen, (di,), 0.0, cfg.pdtype),
        "wq": blk(), "wk": blk(), "wv": blk(),
        "w_if": L.dense_init(gen, di, 2 * h, F32),
        "gn": L.full(gen, (di,), 1.0, F32),   # per-head group norm scale
        "down_proj": L.dense_init(gen, di, d, cfg.pdtype),
    }


def _tril(n: int, device) -> torch.Tensor:
    return torch.ones((n, n), dtype=torch.bool, device=device).tril()


def _mlstm_parallel(q, k, v, i_log, f_log):
    """Stabilised parallel mLSTM. q,k,v [B,L,H,Dh]; gates [B,L,H] (logits).

    logD_ij = cum_i - cum_j + i_j (j <= i), m_i = rowmax, S = exp(logD - m)
    * (q.k/sqrt d); h = S v / max(|rowsum S|, exp(-m)).
    """
    b, l, h, dh = q.shape
    logf = F.logsigmoid(f_log).float()                        # [B,L,H]
    cum = torch.cumsum(logf, dim=1).transpose(1, 2)           # [B,H,L]
    ii = i_log.float().transpose(1, 2)
    logd = cum[:, :, :, None] - cum[:, :, None, :] + ii[:, :, None, :]
    logd = torch.where(_tril(l, q.device)[None, None], logd, -torch.inf)
    m = torch.amax(logd, dim=-1)                              # [B,H,L]
    d_mat = torch.exp(logd - m[..., None])
    qk = torch.einsum("blhd,bshd->bhls", q.float(), k.float()) / math.sqrt(dh)
    s = d_mat * qk
    denom = torch.maximum(torch.abs(torch.sum(s, dim=-1)), torch.exp(-m))
    out = torch.einsum("bhls,bshd->blhd", s.to(q.dtype), v)
    return out / denom.transpose(1, 2)[..., None].to(q.dtype)


def _mlstm_chunkwise(q, k, v, i_log, f_log, chunk: int):
    """Chunkwise-parallel mLSTM: a Python loop over chunks carrying the
    (C, n, m) matrix-memory state, quadratic only within a chunk. Matches
    the quadratic form to float tolerance."""
    b, l, h, dh = q.shape
    pad = -l % chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        i_log = F.pad(i_log, (0, 0, 0, pad), value=-1e30)  # never fire
        f_log = F.pad(f_log, (0, 0, 0, pad))
    scale = 1.0 / math.sqrt(dh)
    mask = _tril(chunk, q.device)[None, None]
    c0 = torch.zeros((b, h, dh, dh), dtype=F32, device=q.device)
    n0 = torch.zeros((b, h, dh), dtype=F32, device=q.device)
    m0 = torch.full((b, h), -1e30, dtype=F32, device=q.device)
    ctxs = []
    for lo in range(0, l + pad, chunk):
        qc, kc, vc = q[:, lo:lo + chunk], k[:, lo:lo + chunk], \
            v[:, lo:lo + chunk]
        ic, fc = i_log[:, lo:lo + chunk], f_log[:, lo:lo + chunk]
        logf = F.logsigmoid(fc).float()                       # [B,C,H]
        bcum = torch.cumsum(logf, dim=1)                      # [B,C,H]
        ii = ic.float()
        g = torch.cummax(ii - bcum, dim=1).values
        m_i = bcum + torch.maximum(g, m0[:, None, :])         # [B,C,H]
        # intra-chunk: logD_ij = b_i - b_j + i_j - m_i (j <= i)
        bt, it = bcum.transpose(1, 2), ii.transpose(1, 2)
        logd = bt[:, :, :, None] - bt[:, :, None, :] + it[:, :, None, :]
        logd = torch.where(mask, logd, -torch.inf)
        d_mat = torch.exp(logd - m_i.transpose(1, 2)[..., None])
        qk = torch.einsum("bihd,bjhd->bhij", qc.float(), kc.float()) * scale
        s = d_mat * qk                                        # [B,H,C,C]
        num_intra = torch.einsum("bhij,bjhd->bihd", s.to(qc.dtype), vc)
        den_intra = torch.sum(s, dim=-1).transpose(1, 2)      # [B,C,H]
        # inter-chunk: the carried state (k was scaled into it)
        inter_scale = torch.exp(bcum + m0[:, None, :] - m_i)  # [B,C,H]
        q32 = qc.float()
        # c0[b,h,d,e]: d = value index, e = key index
        num_inter = torch.einsum("bihe,bhde->bihd", q32, c0) \
            * inter_scale[..., None]
        den_inter = torch.einsum("bihd,bhd->bih", q32, n0) * inter_scale
        den = torch.maximum(torch.abs(den_intra + den_inter),
                            torch.exp(-m_i))[..., None]
        ctx = (num_intra.float() + num_inter) / den
        ctxs.append(ctx.to(qc.dtype))
        # state update to the end of the chunk
        b_end = bcum[:, -1]                                   # [B,H]
        m_new = m_i[:, -1]
        w_j = torch.exp(b_end[:, None, :] - bcum + ii - m_new[:, None, :])
        k32 = kc.float() * scale
        decay = torch.exp(b_end + m0 - m_new)
        c0 = decay[..., None, None] * c0 + torch.einsum(
            "bjh,bjhd,bjhe->bhde", w_j, vc.float(), k32)
        n0 = decay[..., None] * n0 + torch.einsum("bjh,bjhd->bhd", w_j, k32)
        m0 = m_new
    return torch.cat(ctxs, dim=1)[:, :l]


def _mlstm_qkv_gates(p, cfg, x_c, x_in):
    """q, k, v [B,L,H,Dh] and the gate logits [B,L,H] each (f32)."""
    b, l, di = x_c.shape
    h = cfg.n_heads
    xh = x_c.reshape(b, l, h, di // h)
    q = torch.einsum("blhd,hde->blhe", xh, p["wq"])
    k = torch.einsum("blhd,hde->blhe", xh, p["wk"])
    v = torch.einsum("blhd,hde->blhe", x_in.reshape(b, l, h, di // h),
                     p["wv"])
    gates = x_c.float() @ p["w_if"]            # bf16 @ f32 promotes to f32
    return q, k, v, gates[..., :h], gates[..., h:]


def mlstm_train(p, cfg, x):
    b, l, d = x.shape
    di = cfg.ssm_expand * d
    xn = L.rms_norm(x, p["norm"], cfg.norm_eps)
    x_in, z = torch.chunk(xn @ p["up_proj"], 2, dim=-1)
    x_c = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"]))
    q, k, v, i_log, f_log = _mlstm_qkv_gates(p, cfg, x_c, x_in)
    if cfg.mlstm_chunk and l > cfg.mlstm_chunk:
        ctx = _mlstm_chunkwise(q, k, v, i_log, f_log, cfg.mlstm_chunk)
    else:
        ctx = _mlstm_parallel(q, k, v, i_log, f_log)          # [B,L,H,Dh]
    ctx = L.rms_norm(ctx.reshape(b, l, di), p["gn"], cfg.norm_eps)
    return (ctx * F.silu(z)) @ p["down_proj"]


def mlstm_cache(cfg, batch: int, device=None):
    device = resolve(device)
    di = cfg.ssm_expand * cfg.d_model
    h = cfg.n_heads
    dh = di // h
    return {
        "C": torch.zeros((batch, h, dh, dh), dtype=F32, device=device),
        "n": torch.zeros((batch, h, dh), dtype=F32, device=device),
        "m": torch.full((batch, h), -torch.inf, dtype=F32, device=device),
        "conv": torch.zeros((batch, 3, di), dtype=F32, device=device),
    }


def mlstm_decode(p, cfg, x, cache):
    """x [B,1,d] -> (out [B,1,d], cache updated in place). O(1) state
    update; on the first step ``m`` is -inf and the forget weight
    exp(logf + m - m_new) is 0."""
    b, _, d = x.shape
    di = cfg.ssm_expand * d
    h = cfg.n_heads
    dh = di // h
    xn = L.rms_norm(x, p["norm"], cfg.norm_eps)
    x_in, z = torch.chunk((xn @ p["up_proj"])[:, 0], 2, dim=-1)  # [B,dI]
    x_c = _conv_step(cache, x_in, p["conv_w"], p["conv_b"])       # f32
    xh = x_c.reshape(b, h, dh).to(x.dtype)
    q = torch.einsum("bhd,hde->bhe", xh, p["wq"]).float()
    k = torch.einsum("bhd,hde->bhe", xh, p["wk"]).float() / math.sqrt(dh)
    v = torch.einsum("bhd,hde->bhe", x_in.reshape(b, h, dh).to(x.dtype),
                     p["wv"]).float()
    gates = x_c @ p["w_if"]
    i_log, f_logit = gates[..., :h], gates[..., h:]
    logf = F.logsigmoid(f_logit)
    m_old = cache["m"]
    m_new = torch.maximum(logf + m_old, i_log)
    i_p = torch.exp(i_log - m_new)[..., None]
    f_p = torch.exp(logf + m_old - m_new)[..., None]
    c_new = cache["C"].mul_(f_p[..., None]).add_(
        i_p[..., None] * (v[..., :, None] * k[..., None, :]))
    n_new = cache["n"].mul_(f_p).add_(i_p * k)
    cache["m"].copy_(m_new)
    num = torch.einsum("bhde,bhe->bhd", c_new, q)
    den = torch.maximum(torch.abs(torch.sum(n_new * q, dim=-1)),
                        torch.exp(-m_new))[..., None]
    ctx = (num / den).reshape(b, di)
    ctx = L.rms_norm(ctx, p["gn"], cfg.norm_eps).to(x.dtype)
    out = ((ctx * F.silu(z)) @ p["down_proj"])[:, None]
    return out, cache


# ================================================================== sLSTM

def init_slstm(gen, cfg) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    ff = int(d * 4 / 3 / 64) * 64 or 64
    return {
        "norm": L.full(gen, (d,), 1.0, F32),
        "w": L.dense_init(gen, d, 4 * d, cfg.pdtype),         # z,i,f,o
        "r": (L.normal(gen, (h, dh, 4 * dh)) * (1 / dh) ** 0.5
              ).to(cfg.pdtype),
        "b": L.full(gen, (4 * d,), 0.0, F32),
        "gn": L.full(gen, (d,), 1.0, F32),
        "ffn_norm": L.full(gen, (d,), 1.0, F32),
        "gate": L.dense_init(gen, d, ff, cfg.pdtype),
        "up": L.dense_init(gen, d, ff, cfg.pdtype),
        "down": L.dense_init(gen, ff, d, cfg.pdtype),
    }


def slstm_cache(cfg, batch: int, device=None):
    device = resolve(device)
    h = cfg.n_heads
    shape = (batch, h, cfg.d_model // h)
    return {
        "c": torch.zeros(shape, dtype=F32, device=device),
        "n": torch.full(shape, 1e-6, dtype=F32, device=device),
        "h": torch.zeros(shape, dtype=F32, device=device),
        "m": torch.zeros(shape, dtype=F32, device=device),  # per unit
    }


def _slstm_cell(p, cfg, wx_t, state):
    """One step. wx_t [B, 4d] precomputed W x_t + b; state dict -> (new
    state dict, h_out [B,h,dh])."""
    b = wx_t.shape[0]
    h = cfg.n_heads
    dh = cfg.d_model // h
    rh = torch.einsum("bhd,hde->bhe", state["h"].to(p["r"].dtype), p["r"])
    gates = wx_t.reshape(b, h, 4 * dh).float() + rh.float()
    zt, it, ft, ot = torch.chunk(gates, 4, dim=-1)            # [B,h,dh]
    z = torch.tanh(zt)
    o = torch.sigmoid(ot)
    # exponential gating with a per-unit stabiliser (f = exp form)
    m_new = torch.maximum(ft + state["m"], it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(ft + state["m"] - m_new)
    c = f_p * state["c"] + i_p * z
    n = f_p * state["n"] + i_p
    h_out = o * (c / torch.clamp_min(n, 1e-6))
    return {"c": c, "n": n, "h": h_out, "m": m_new}, h_out


def _slstm_out(p, cfg, x, hs):
    """The sLSTM block's group norm, residual and gated FFN."""
    y = L.rms_norm(hs, p["gn"], cfg.norm_eps).to(x.dtype)
    x = x + y
    hn = L.rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    return x + L.swiglu(hn, p["gate"], p["up"], p["down"])


def slstm_train(p, cfg, x):
    """Time-serial: a Python loop over the tokens."""
    b, l, d = x.shape
    xn = L.rms_norm(x, p["norm"], cfg.norm_eps)
    wx = xn @ p["w"] + p["b"]                   # bf16 + f32 promotes to f32
    state = slstm_cache(cfg, b, x.device)
    hs = []
    for t in range(l):
        state, h_t = _slstm_cell(p, cfg, wx[:, t], state)
        hs.append(h_t)
    return _slstm_out(p, cfg, x, torch.stack(hs, dim=1).reshape(b, l, d))


def slstm_decode(p, cfg, x, cache):
    """x [B,1,d] -> (out [B,1,d], cache updated in place)."""
    xn = L.rms_norm(x, p["norm"], cfg.norm_eps)
    wx = (xn @ p["w"] + p["b"])[:, 0]
    new, h_out = _slstm_cell(p, cfg, wx, cache)
    for name, t in new.items():
        cache[name].copy_(t)
    b = x.shape[0]
    return _slstm_out(p, cfg, x, h_out.reshape(b, cfg.d_model)[:, None]), \
        cache
