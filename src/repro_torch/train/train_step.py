"""Training step factory (port of ``repro/train/train_step.py``): CE loss
(+ MoE aux), grads, AdamW.

``make_train_step`` splits the batch into ``cfg.microbatches`` along dim
0 and runs one backward a microbatch; the gradients accumulate in place
in one tree in the param dtype (each leaf's ``.grad``; a stacked
param's layers add into their slots, ``models.layers.index``), the
reference's arithmetic (0 + g1 exactly, then each sum rounded to the
param dtype, then ``/ n``). Metrics are the means over the microbatches.

``make_compressed_dp_train_step`` is the reference's explicit data
parallelism with int8 gradient compression and error feedback, on one
controller as the sharded index is (``ann/sharded.py``): the batch splits
over the data axis of a ``launch/mesh.py`` mesh, shard *i* computes its
grads on its device, adds its residual, quantizes each leaf to int8 with
a per-leaf scale and keeps the new residual; the codes are summed in
int32 in linear shard order and scaled by the mean scale, as the
reference's ``psum`` / ``ssum / n``; the metrics are the shards' mean
(``pmean``). The residual ``ef`` keeps one buffer a data shard, stacked
[n, ...] (each device of the reference holds its own buffer of the
replicated ``ef``); a leading dim of 1 (``init_ef_state``) is every
shard's starting value, as the reference's replicated input is.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.utils.tree import leaves, tree_map, tree_unflatten

MOE_AUX_WEIGHT = 0.01
F32 = torch.float32


def ce_loss(logits, labels, vocab_size: int):
    """Mean cross-entropy in f32 with the padded vocab tail masked out
    (-1e30). The label logit is gathered: on one device there is no
    vocab-sharded tensor to keep whole, and the gather equals the
    reference's masked sum exactly."""
    vp = logits.shape[-1]
    logits = logits.float()
    if vp > vocab_size:
        pad = torch.arange(vp, device=logits.device) >= vocab_size
        logits = torch.where(pad, -1e30, logits)
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - label_logit)


def chunked_ce_loss(x, lm_head, labels, vocab_size: int, chunk: int = 512):
    """CE with the lm_head projection chunked over the sequence, each
    chunk checkpointed (its logits recomputed in the backward), so the
    full-sequence logits never exist. A sequence that ``chunk`` does not
    divide is one chunk, as in the reference."""
    b, s, _ = x.shape
    if s % chunk:
        chunk = s
    n = s // chunk

    def body(xc, w, lc):
        logits = torch.einsum("bsd,dv->bsv", xc, w)
        return ce_loss(logits, lc, vocab_size) * (1.0 / n)

    body = L.remat(body)
    total = torch.zeros((), dtype=F32, device=x.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + body(x[:, sl], lm_head, labels[:, sl])
    return total


def make_loss_fn(cfg: ModelConfig, ce_chunk: int = 512):
    api = build_model(cfg)

    def loss_fn(params, batch):
        x, aux = api.features(params, cfg, batch)
        loss = chunked_ce_loss(x, params["lm_head"], batch["labels"],
                               cfg.vocab_size, ce_chunk)
        aux = torch.as_tensor(aux, dtype=F32, device=loss.device)
        total = loss + MOE_AUX_WEIGHT * aux
        return total, {"loss": loss, "moe_aux": aux}

    return loss_fn


def accumulate_grads(loss_fn, params, batches: list):
    """One backward per batch of ``batches``, the gradients summed in
    place in the params' ``.grad`` and divided by their number. Returns
    (grads, metrics: the means over the batches); the params leave
    without ``.grad`` and without ``requires_grad``."""
    ps = [p for p in leaves(params) if p.is_floating_point()]
    for p in ps:
        p.grad = None
        p.requires_grad_(True)
    ms = []
    try:
        with torch.enable_grad():
            for batch in batches:
                total, m = loss_fn(params, batch)
                total.backward()
                ms.append({k: v.detach() for k, v in m.items()})
    finally:
        for p in ps:
            p.requires_grad_(False)
    grads = tree_map(lambda p: p.grad if p.grad is not None
                     else torch.zeros_like(p), params)
    for p in ps:
        p.grad = None
    if len(batches) > 1:
        for g in leaves(grads):
            g.div_(len(batches))
    metrics = {k: torch.mean(torch.stack([m[k] for m in ms])) for k in ms[0]}
    return grads, metrics


def split_batch(batch: dict, n: int) -> list:
    """``n`` batches of consecutive rows (the reference's reshape to
    [n, B / n, ...])."""
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"a batch of {b} does not split into {n}")
    return [{k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
            for i in range(n)]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); params and moments are updated in place."""
    loss_fn = make_loss_fn(cfg)
    n_micro = max(cfg.microbatches, 1)

    def train_step(params, opt_state, batch):
        grads, metrics = accumulate_grads(loss_fn, params,
                                          split_batch(batch, n_micro))
        params, opt_state, opt_metrics = adamw_update(grads, opt_state,
                                                      params, opt_cfg)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


def init_train_state(seed: int, cfg: ModelConfig, opt_cfg: AdamWConfig,
                     device=None):
    """(params, opt_state): ``init_params(seed, cfg, device)`` (the card
    unless the caller passes ``"cpu"``) and its AdamW state."""
    params = build_model(cfg).init_params(seed, cfg, device)
    return params, adamw_init(params, opt_cfg)


# ------------------------------------------------- int8 grad compression

def quantize_int8(g: torch.Tensor):
    """Per-tensor symmetric int8: (codes, f32 scale). ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale.to(F32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor):
    return q.to(F32) * scale


def init_ef_state(params, opt_state):
    """``opt_state`` with a zero f32 residual [1, *shape] per param."""
    ef = tree_map(lambda p: torch.zeros((1, *p.shape), dtype=F32,
                                        device=p.device), params)
    return {**opt_state, "ef": ef}


def _on(params, device):
    """``params`` on ``device``: the same tensors there, else a copy."""
    return tree_map(lambda p: p.to(device), params)


def make_compressed_dp_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                                  mesh, data_axis: str = "data"):
    """Explicit-DP train step with an int8 all-reduce and error feedback
    over ``data_axis`` of ``mesh`` (a ``launch/mesh.py`` mesh), as the
    module docstring says. Returns train_step(params, opt_state, batch)
    -> (params, opt_state, metrics); ``opt_state`` needs ``ef``
    (``init_ef_state``)."""
    loss_fn = make_loss_fn(cfg)
    n = mesh.shape[mesh.axis_names.index(data_axis)]
    # the first shard of each data index, in linear (data-major) order
    shard_devices = [mesh.devices[i * (mesh.size // n)] for i in range(n)]

    def train_step(params, opt_state, batch):
        home = leaves(params)[0].device
        ef = leaves(opt_state["ef"])
        codes = [[] for _ in ef]
        scales = [[] for _ in ef]
        new_ef = [[] for _ in ef]
        shard_metrics = []
        for i, (dev, shard) in enumerate(zip(shard_devices,
                                             split_batch(batch, n))):
            grads, m = accumulate_grads(loss_fn, _on(params, dev),
                                        [{k: v.to(dev)
                                          for k, v in shard.items()}])
            shard_metrics.append(m)
            for j, g in enumerate(leaves(grads)):
                e = ef[j][i if ef[j].shape[0] > 1 else 0]
                g32 = g.float() + e.to(dev)              # error feedback in
                q, scale = quantize_int8(g32)
                new_ef[j].append((g32 - dequantize_int8(q, scale)).to(home))
                codes[j].append(q.to(home))
                scales[j].append(scale.to(home))
            del grads
        reduced = []
        for j, p in enumerate(leaves(params)):
            qsum = codes[j][0].to(torch.int32)
            ssum = scales[j][0]
            for q, s in zip(codes[j][1:], scales[j][1:]):
                qsum = qsum + q.to(torch.int32)
                ssum = ssum + s
            reduced.append((qsum.to(F32) * (ssum / n) / n).to(p.dtype))
        grads = tree_unflatten(params, reduced)
        ef_tree = tree_unflatten(opt_state["ef"],
                                 [torch.stack(e) for e in new_ef])
        metrics = {k: torch.mean(torch.stack([m[k].to(home)
                                              for m in shard_metrics]))
                   for k in shard_metrics[0]}
        inner = {k: v for k, v in opt_state.items() if k != "ef"}
        params, inner, opt_metrics = adamw_update(grads, inner, params,
                                                  opt_cfg)
        return params, {**inner, "ef": ef_tree}, {**metrics, **opt_metrics}

    return train_step

