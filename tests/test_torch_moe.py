"""The moe family of the port (``models/moe.py`` and the transformer's moe
branch) against the JAX reference on the CPU.

The routing is selection, so it is held bitwise: the dispatch tables
given the same ``top_e`` (the reference's own table code, ``moe.py:107-
121,133-134``, run on the same input), and the top-k given the same router
probabilities, ties included. The rest is held within 1e-5 for the FFN,
1e-4 for a model's logits and caches, 1e-3 for decode against teacher-
forced (the reference's own bound, at ``capacity_factor = E / k`` so that
no token drops), and the measured bf16 gaps of ``BF16_MOE_BOUNDS``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import (BF16, CPU, batch, close, configs, port_decode,
                       ref_decode, ref_fns, rel_l2, t, world,
                       decode_vs_teacher_forced)
from repro.models import moe as RM
from repro.models import transformer as RT
from repro_torch import convert
from repro_torch.kernels.ref import topk_ref
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

ARCH = "qwen2-moe-a2.7b"


def _ref_tables(top_e, e, cap):
    """The reference's routing tables, its own lines (``moe.py:107-121,
    133-134``) on ``top_e`` [B, S, k]."""
    b, s, k = top_e.shape
    flat_e = top_e.reshape(b, s * k)
    order = jnp.argsort(flat_e, axis=-1, stable=True)
    sorted_e = jnp.take_along_axis(flat_e, order, axis=-1)
    first = jax.vmap(
        lambda se: jnp.searchsorted(se, se, side="left"))(sorted_e)
    rank = jnp.arange(s * k)[None, :] - first
    keep = rank < cap
    token_sorted = order // k
    b_iota = jnp.broadcast_to(jnp.arange(b)[:, None], (b, s * k))
    slot_sorted = jnp.where(keep, sorted_e * cap + rank, e * cap)
    slot_token = jnp.full((b, e * cap + 1), s, jnp.int32).at[
        b_iota, slot_sorted].set(token_sorted.astype(jnp.int32), mode="drop")
    slot_token = slot_token[:, :e * cap]
    inv_order = jnp.argsort(order, axis=-1)
    slot_orig = jnp.take_along_axis(slot_sorted, inv_order, axis=-1)
    return slot_token, slot_orig, keep


@pytest.mark.parametrize("b,s,k,e,cap", [
    (2, 16, 4, 8, 8),     # capacity_factor 1.0 at s = 16: pairs drop
    (2, 16, 4, 8, 1),     # most pairs drop
    (3, 16, 4, 8, 16),    # capacity_factor E / k: none can drop
    (8, 1, 4, 60, 1),     # decode at qwen2-moe's width
    (2, 33, 2, 8, 3)])
def test_dispatch_tables_equal_the_reference(b, s, k, e, cap):
    """Given the same ``top_e`` (each token's k distinct experts, drawn so
    that experts overflow), the slot of every pair, the source token of
    every slot and the capacity cut equal the reference's, bit for bit."""
    rng = np.random.default_rng(b * 100 + cap)
    top_e = np.stack([np.stack([rng.permutation(e)[:k] for _ in range(s)])
                      for _ in range(b)]).astype(np.int32)
    want = _ref_tables(jnp.asarray(top_e), e, cap)
    got = M.dispatch(t(top_e).long(), e, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if cap < s * k / e:
        assert not bool(got[2].all())      # the case drops pairs


def test_topk_order_at_ties():
    """Router top-k in ``lax.top_k``'s order on probabilities with exact
    ties (the lowest expert wins), values and indices bitwise."""
    rng = np.random.default_rng(3)
    probs = rng.integers(0, 4, (64, 60)).astype(np.float32) / 8
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 4)
    got_v, got_i = topk_ref(t(probs), 4)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def _moe_world(cf):
    rcfg, pcfg, ref, params = world(ARCH, capacity_factor=cf)
    lp = jax.tree.map(lambda a: a[0], ref["blocks"]["moe"])
    return rcfg, pcfg, lp, T.layer(params, 0)["moe"]


@pytest.mark.parametrize("cf", [1.0, 1.25, 2.0])
def test_moe_ffn_against_the_reference(cf):
    """``moe_ffn`` of one layer at s = 16 (capacity_factor 1.0 drops
    pairs, E / k = 2 cannot): output within 1e-5, the aux loss within
    1e-6, the router's probabilities within 1e-6; and the [B, d] form of a
    decode step."""
    rcfg, pcfg, rp, p = _moe_world(cf)
    x = np.random.default_rng(4).normal(size=(2, 16, pcfg.d_model)
                                        ).astype(np.float32)
    want, want_aux = RM.moe_ffn(rp, rcfg, jnp.asarray(x))
    got, aux = M.moe_ffn(p, pcfg, t(x))
    close(got, want, 1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    probs, _, top_e = M.route(p, pcfg, t(x))
    close(probs, jax.nn.softmax(jnp.asarray(x) @ rp["router"], -1), 1e-6)
    cap = M.capacity(pcfg, 16)
    assert cap == max(math.ceil(16 * 4 / 8 * cf), 1)
    keep = M.dispatch(top_e, pcfg.n_experts, cap)[2]
    assert bool(keep.all()) == (cf != 1.0), int((~keep).sum())
    want, _ = RM.moe_ffn(rp, rcfg, jnp.asarray(x[:, 0]))
    got, _ = M.moe_ffn(p, pcfg, t(x[:, 0]))
    assert got.shape == (2, pcfg.d_model)
    close(got, want, 1e-5)


@pytest.mark.parametrize("arch", [ARCH, "phi3.5-moe-42b-a6.6b"])
def test_apply_and_decode_against_the_reference(arch):
    """``apply`` over 16 tokens (published capacity factor: pairs drop)
    with its aux loss, and 10 ``decode_step``s: logits and both caches
    within 1e-4 of the reference's."""
    rcfg, pcfg, ref, params = world(arch)
    rbatch, batch_ = batch(pcfg, 2, 16)
    want, want_aux = ref_fns(rcfg)[0](ref, rcfg, rbatch)
    got, aux = T.apply(params, pcfg, batch_)
    close(got, want, 1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    want, rcache = ref_decode(rcfg, ref, rbatch, 12, 10)
    got, cache = port_decode(pcfg, params, batch_, 12, 10)
    close(got, want, 1e-4)
    close(cache["k"], rcache["k"], 1e-4)
    close(cache["v"], rcache["v"], 1e-4)


@pytest.mark.parametrize("arch", [ARCH, "phi3.5-moe-42b-a6.6b"])
def test_decode_matches_teacher_forced(arch):
    """Decode vs teacher-forced within 1e-3 at ``capacity_factor = E /
    k``, where no token can drop (the reference's test uses 1000)."""
    cfg = configs(arch)[1]
    err = decode_vs_teacher_forced(
        arch, capacity_factor=cfg.n_experts / cfg.moe_top_k)
    assert err < 1e-3, err


# The bf16 moe model against the reference's bf16 run, relative L2 of
# the logits of a 16-token apply, of 10 decode steps and of the caches.
# New bf16 paths beside the dense model's: the f32 router softmax of the
# bf16 activations, the experts' bf16 products and the bf16 sum over a
# token's k choices. Measured at the reduced qwen2-moe and the seeds below
# (``pytest -s`` prints them): as drawn 1.046e-2 (apply), 1.004e-2
# (decode), 5.19e-3 and 5.31e-3 (caches); with every gate weight zeroed
# (the routed and shared experts then add exact zeros, which isolates the
# router, its top-k and the attention from XLA's five-op bf16 ``silu``)
# 0, 0, 0 and 0.
BF16_MOE_BOUNDS = {
    "drawn": dict(apply=1.3e-2, decode=1.3e-2, k=6.5e-3, v=6.5e-3),
    "gate_zeroed": dict(apply=1e-3, decode=1e-3, k=1e-3, v=1e-3),
}


@pytest.mark.parametrize("weights", sorted(BF16_MOE_BOUNDS))
def test_bf16_model_against_the_reference(weights):
    """The reduced qwen2-moe in bf16 (capacity_factor E / k) against the
    reference's bf16 run, each gap within its bound above."""
    rcfg, pcfg = configs(ARCH, capacity_factor=2.0, **BF16)
    arrays = jax.tree.map(np.asarray,
                          RT.init_params(jax.random.PRNGKey(2), rcfg))
    if weights == "gate_zeroed":
        for name in ("w_gate", "shared_gate"):
            arrays["blocks"]["moe"][name] = np.zeros_like(
                arrays["blocks"]["moe"][name])
    ref = jax.tree.map(jnp.asarray, arrays)
    params = convert.lm_params(arrays, pcfg, CPU)
    rbatch, batch_ = batch(pcfg, 2, 16, seed=6)
    gaps = {}
    want, _ = ref_fns(rcfg)[0](ref, rcfg, rbatch)
    got, _ = T.apply(params, pcfg, batch_)
    assert got.dtype == torch.bfloat16
    gaps["apply"] = rel_l2(got, want)
    want, rcache = ref_decode(rcfg, ref, rbatch, 12, 10)
    got, cache = port_decode(pcfg, params, batch_, 12, 10)
    gaps["decode"] = rel_l2(got, want)
    gaps["k"] = rel_l2(cache["k"], rcache["k"])
    gaps["v"] = rel_l2(cache["v"], rcache["v"])
    print(weights, gaps)
    bounds = BF16_MOE_BOUNDS[weights]
    assert all(gaps[n] <= bounds[n] for n in bounds), (gaps, bounds)


def test_init_shapes_dtypes_and_scales():
    """The torch-seeded init has the reference's tree, shapes and dtypes
    (the router f32, the experts bf16 [E, d, ff]); each expert's std
    within 5% of ``d_in ** -0.5``."""
    rcfg, pcfg = configs(ARCH, param_dtype="bfloat16")
    want = jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0),
                                                 rcfg))
    got = T.init_params(0, pcfg, CPU)
    flat_want = {jax.tree_util.keystr(p): a for p, a in
                 jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_got = {jax.tree_util.keystr(p): a for p, a in
                jax.tree_util.tree_flatten_with_path(got)[0]}
    assert flat_got.keys() == flat_want.keys()
    for name, a in flat_want.items():
        assert tuple(flat_got[name].shape) == a.shape, name
        assert str(flat_got[name].dtype) == f"torch.{a.dtype.name}", name
    moe = got["blocks"]["moe"]
    assert moe["router"].dtype == torch.float32
    for name, d_in in (("w_gate", pcfg.d_model), ("w_up", pcfg.d_model),
                       ("w_down", pcfg.expert_ff()),
                       ("shared_gate", pcfg.d_model)):
        std = float(moe[name].float().std())
        assert abs(std / d_in ** -0.5 - 1) < 0.05, (name, std)
    # the experts of one layer are drawn apart, not copies
    assert not torch.equal(moe["w_up"][0, 0], moe["w_up"][0, 1])
