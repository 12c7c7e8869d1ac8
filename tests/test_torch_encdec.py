"""The encdec family of the port (``models/encdec.py``, whisper-tiny's
reduced config) against the JAX reference on the CPU.

Tolerances: 2.5e-4 for the position table (see ``test_sinusoid``), 1e-4 for the encoder's states,
the cross K/V, a model's logits and caches, 1e-3 for decode against
teacher-forced (the reference's own bound), and the measured bf16 gaps of
``BF16_ENCDEC_BOUNDS``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import (CPU, batch, bf16_gaps, close, decode_vs_teacher_forced,
                       gelu_once, port_decode, ref_decode, ref_fns, t,
                       world)
from repro.models import encdec as RE
from repro_torch.models import encdec as E

ARCH = "whisper-tiny"


def test_sinusoid():
    """The position table at every position below 2,048 (past whisper's
    1,500 frames and the served cache's 1,024 tokens) within 2.5e-4: XLA's
    f32 ``exp`` gives 22 of the 192 frequencies one ulp (at most 6e-8) away
    from torch's, and an angle carries that ulp times its position (up to
    1.2e-4 here)."""
    pos = np.arange(2048, dtype=np.int32).reshape(2, 1024)
    got = E._sinusoid(t(pos), 384)
    want = RE._sinusoid(jnp.asarray(pos), 384)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2.5e-4)


@pytest.mark.parametrize("n_frames", [64, 80])
def test_encode_prefill_against_the_reference(n_frames):
    """The encoder's states and every layer's cross K/V after
    ``encode_prefill``; 80 frames pass ``attn_chunk`` (64): flash, padded.
    The prefill leaves the self-attention caches and lengths alone."""
    rcfg, pcfg, ref, params = world(ARCH, n_frames=n_frames)
    rbatch, batch_ = batch(pcfg, 2, 4)
    close(E.encode(params, pcfg, batch_["frames"]),
          RE.encode(ref, rcfg, rbatch["frames"]), 1e-4)
    rcache = ref_fns(rcfg)[2](ref, rcfg, rbatch["frames"],
                              RE.init_cache(rcfg, 2, 8))
    cache = E.encode_prefill(params, pcfg, batch_["frames"],
                             E.init_cache(pcfg, 2, 8, CPU))
    assert cache["xk"].shape == (pcfg.n_layers, 2, n_frames,
                                 pcfg.n_kv_heads, pcfg.head_dim_)
    for name in ("xk", "xv"):
        close(cache[name], rcache[name], 1e-4)
    assert not cache["k"].any() and not cache["len"].any()


@pytest.mark.parametrize("s,n_frames,max_len", [
    (16, 64, 12), (80, 80, 12), (16, 64, 6)])
def test_apply_and_decode_against_the_reference(s, n_frames, max_len):
    """``apply`` over s tokens (80: the decoder's self-attention and the
    cross-attention through flash), and 10 ``decode_step``s after
    ``encode_prefill``: logits and both self-attention caches within 1e-4;
    at max_len 6 the last steps write past the end, where the reference
    clamps the row to the last one."""
    rcfg, pcfg, ref, params = world(ARCH, n_frames=n_frames)
    rbatch, batch_ = batch(pcfg, 2, s)
    want, _ = ref_fns(rcfg)[0](ref, rcfg, rbatch)
    got, aux = E.apply(params, pcfg, batch_)
    close(got, want, 1e-4)
    assert float(aux) == 0.0
    want, rcache = ref_decode(rcfg, ref, rbatch, max_len, 10)
    got, cache = port_decode(pcfg, params, batch_, max_len, 10)
    close(got, want, 1e-4)
    for name in ("k", "v", "xk", "xv"):
        close(cache[name], rcache[name], 1e-4)
    assert cache["len"].tolist() == np.asarray(rcache["len"]).tolist()


def test_decode_matches_teacher_forced():
    err = decode_vs_teacher_forced(ARCH)
    assert err < 1e-3, err


# The bf16 whisper against the reference's bf16 run, relative L2 of the
# logits of a 16-token apply and of 10 decode steps (``pytest -s`` prints
# them). New bf16 paths: LayerNorm with biases, the biased projections,
# the tanh GELU and the cross-attention over the prefilled bf16 K/V.
# Measured at the reduced whisper-tiny and the seeds below: as drawn
# 6.19e-3 (apply) and 6.14e-3 (decode); with the reference's
# ``jax.nn.gelu`` rounded once like ``F.gelu`` (``gelu_once``) 5.72e-3 and
# 5.74e-3. Unlike the dense model's silu, XLA's multi-op bf16 GELU is not
# what sets this gap: rounding flips at near-ties, which attention spreads
# over every position, leave the two about one bf16 step apart.
BF16_ENCDEC_BOUNDS = {
    "drawn": dict(apply=8e-3, decode=8e-3),
    "gelu_once": dict(apply=7.5e-3, decode=7.5e-3),
}


@pytest.mark.parametrize("case", sorted(BF16_ENCDEC_BOUNDS))
def test_bf16_against_the_reference(case, monkeypatch):
    """The reduced whisper-tiny in bf16 against the reference's bf16 run
    (with ``gelu_once``: unjitted, its GELU rounded once), each gap within
    its bound above."""
    if case == "gelu_once":
        monkeypatch.setattr(jax.nn, "gelu", gelu_once)
    gaps = bf16_gaps(ARCH, E.apply, eager=case == "gelu_once")
    print(case, gaps)
    bounds = BF16_ENCDEC_BOUNDS[case]
    assert all(gaps[n] <= b for n, b in bounds.items()), (gaps, bounds)


def test_init_shapes_and_dtypes():
    """The torch-seeded init has the reference's tree, shapes and dtypes
    in bf16 (the LayerNorm weights and biases f32)."""
    import dataclasses
    from repro.configs import registry as RR
    from repro_torch.configs import registry as PR
    rcfg = dataclasses.replace(RR.reduced_config(ARCH),
                               param_dtype="bfloat16")
    pcfg = dataclasses.replace(PR.reduced_config(ARCH),
                               param_dtype="bfloat16")
    want = jax.eval_shape(lambda: RE.init_params(jax.random.PRNGKey(0), rcfg))
    got = E.init_params(0, pcfg, CPU)
    flat_want = {jax.tree_util.keystr(p): a for p, a in
                 jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_got = {jax.tree_util.keystr(p): a for p, a in
                jax.tree_util.tree_flatten_with_path(got)[0]}
    assert flat_got.keys() == flat_want.keys()
    for name, a in flat_want.items():
        assert tuple(flat_got[name].shape) == a.shape, name
        assert str(flat_got[name].dtype) == f"torch.{a.dtype.name}", name
    assert got["dec"]["x_norm_w"].dtype == torch.float32
