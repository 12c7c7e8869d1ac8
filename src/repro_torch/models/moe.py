"""Mixture-of-Experts FFN with capacity-based sort dispatch (port of
``repro/models/moe.py``; GShard-style):

  router top-k -> stable sort (token, expert) pairs by expert
  -> rank within expert = position - first occurrence (sorted order)
  -> pairs with rank >= capacity are dropped (capacity_factor bounds it)
  -> gather into [B, E, capacity, d] buffers -> batched expert einsums
  -> gather back with routing weights.

Expert weights are stacked [E, ...]. Shared experts (qwen2-moe) are one
always-on swiglu of n_shared * expert_ff. The reference's expert-sharding
anchor (``_constrain_experts``) and its sequence-parallel unshard have no
meaning in one torch process and are not here.

Selection is bitwise given the router's probabilities: the top-k in
``lax.top_k``'s order (``kernels/ref.py::topk_ref``: the lowest index wins
a tie), a stable argsort, ``searchsorted(side="left")`` ranks and the
capacity cut (``dispatch``). At ``s = 1`` (decode) the capacity is 1 per
expert, which holds a token's k distinct experts: no token drops. Every
expert's weights are read at decode, as in the reference's formulation.

Returns (out, aux); aux is the load-balance loss E * sum_e f_e * p_e,
summed over the layers by the caller.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import topk_ref
from repro_torch.models import layers as L


def init_moe(gen, cfg) -> dict:
    """The router in f32, the experts stacked [E, d, ff] (drawn one expert
    at a time into their slots) in ``cfg.pdtype``."""
    d, e = cfg.d_model, cfg.n_experts
    ff = cfg.expert_ff()

    def experts(d_in, d_out):
        out = torch.empty((e, d_in, d_out), dtype=cfg.pdtype,
                          device=L.gen_device(gen))
        for i in range(e):
            out[i] = L.dense_init(gen, d_in, d_out, cfg.pdtype)
        return out

    p = {
        "router": L.dense_init(gen, d, e, torch.float32),
        "w_gate": experts(d, ff),
        "w_up": experts(d, ff),
        "w_down": experts(ff, d),
    }
    if cfg.n_shared_experts:
        sff = cfg.n_shared_experts * ff
        p["shared_gate"] = L.dense_init(gen, d, sff, cfg.pdtype)
        p["shared_up"] = L.dense_init(gen, d, sff, cfg.pdtype)
        p["shared_down"] = L.dense_init(gen, sff, d, cfg.pdtype)
    return p


def capacity(cfg, s: int) -> int:
    """Slots per expert and sequence: ceil(s * k / E * capacity_factor),
    at least 1."""
    return max(int(math.ceil(s * cfg.moe_top_k / cfg.n_experts
                             * cfg.capacity_factor)), 1)


def route(p, cfg, x):
    """Router of ``x`` [B, S, d]: (probs [B, S, E] f32, top_p [B, S, k]
    renormalised, top_e [B, S, k])."""
    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = topk_ref(probs, cfg.moe_top_k)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    return probs, top_p, top_e


def dispatch(top_e, n_experts: int, cap: int):
    """The reference's routing tables, per sequence, from ``top_e``
    [B, S, k]:

    * ``slot_token`` [B, E * cap]: the source token of each expert slot,
      ``S`` for an empty slot;
    * ``slot_orig`` [B, S * k]: the slot of each (token, choice) pair in
      its original order, ``E * cap`` (the zero row) for a dropped pair;
    * ``keep`` [B, S * k]: whether each pair, in expert-sorted order, is
      within its expert's capacity.

    Pairs go to their expert's slots in order of token (a stable sort by
    expert); several dropped pairs all write the sentinel column, which is
    cut off."""
    b, s, k = top_e.shape
    dev = top_e.device
    flat_e = top_e.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(s * k, device=dev)[None, :] - first
    keep = rank < cap
    token_sorted = order // k
    slot_sorted = torch.where(keep, sorted_e * cap + rank, n_experts * cap)
    slot_token = torch.full((b, n_experts * cap + 1), s, dtype=torch.int64,
                            device=dev)
    slot_token.scatter_(1, slot_sorted, token_sorted)
    # the inverse permutation of ``order`` (the reference's argsort of it)
    slot_orig = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    return slot_token[:, :n_experts * cap], slot_orig, keep


def moe_ffn(p: dict, cfg, x):
    """x [B, S, d] (or [B, d]) -> (y like x, aux_loss scalar f32).

    Dispatch is per sequence: sort, rank and capacity are computed within
    each row, capacity ``capacity(cfg, S)``."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[:, None, :]
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    cap = capacity(cfg, s)
    probs, top_p, top_e = route(p, cfg, x)

    # load-balance aux (f_e: fraction routed, p_e: mean router prob)
    f_e = torch.mean(torch.sum(F.one_hot(top_e, e).float(), dim=2),
                     dim=(0, 1)) / k
    p_e = torch.mean(probs, dim=(0, 1))
    aux = e * torch.sum(f_e * p_e)

    slot_token, slot_orig, _ = dispatch(top_e, e, cap)
    # dispatch: gather tokens into [B, E, cap, d] (slot S is a zero row)
    x_pad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    buf = torch.gather(x_pad, 1, slot_token[..., None].expand(-1, -1, d))
    buf = buf.reshape(b, e, cap, d)

    # batched expert swiglu: [B, E, cap, d] x [E, d, ff]
    h = F.silu(torch.einsum("becd,edf->becf", buf, p["w_gate"])) \
        * torch.einsum("becd,edf->becf", buf, p["w_up"])
    y_buf = torch.einsum("becf,efd->becd", h, p["w_down"])

    # combine: each pair's slot in original order (E * cap: the zero row)
    y_flat = torch.cat([y_buf.reshape(b, e * cap, d),
                        y_buf.new_zeros((b, 1, d))], dim=1)
    gathered = torch.gather(y_flat, 1, slot_orig[..., None].expand(-1, -1, d))
    weighted = gathered * top_p.reshape(b, s * k, 1).to(gathered.dtype)
    out = torch.sum(weighted.reshape(b, s, k, d), dim=2)

    if cfg.n_shared_experts:
        out = out + L.swiglu(x, p["shared_gate"], p["shared_up"],
                             p["shared_down"])
    return (out[:, 0] if squeeze else out), aux
