"""The ssm blocks of the port (``models/ssm.py``: Mamba, mLSTM, sLSTM) and
the xLSTM model (``models/xlstm.py``) against the JAX reference on the
CPU.

Tolerances: 1e-5 for one block (f32), 1e-4 for a model's logits and
states, 1e-4 / 1e-5 (rtol / atol) for the selective scan against the
reference's chunked associative scan (``test_selective_scan_chunking_
invariant``'s bound), 5e-3 for a parallel form against its own recurrent
form (the reference's bound), 1e-3 for decode against teacher-forced, and
the measured bf16 gaps of ``BF16_XLSTM_BOUNDS``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import (BF16, CPU, batch, bf16_gaps, close, configs,
                       decode_vs_teacher_forced, flat, port_decode,
                       ref_decode, ref_fns, rel_l2, silu_once, t, world)
from repro.models import ssm as RS
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X

RNG = np.random.default_rng(21)
XLSTM = "xlstm-1.3b"
JAMBA = "jamba-1.5-large-398b"


def _block(init, arch, seed):
    """(reference cfg, port cfg, reference block params, the port's copy)."""
    rcfg, pcfg = configs(arch)
    rp = init(jax.random.PRNGKey(seed), rcfg)
    return rcfg, pcfg, rp, {k: t(v) for k, v in rp.items()}


def _x(cfg, b, s):
    return (RNG.normal(size=(b, s, cfg.d_model)) * 0.3).astype(np.float32)


def _stepwise(decode, p, cfg, x, cache):
    outs = []
    for i in range(x.shape[1]):
        o, cache = decode(p, cfg, x[:, i:i + 1], cache)
        outs.append(o[:, 0])
    return torch.stack(outs, 1), cache


# ------------------------------------------------------------------ mLSTM

def test_mlstm_parallel_matches_recurrent():
    """The port's own parallel form against its own recurrence, within the
    reference's 5e-3 (``tests/test_models.py:137``)."""
    cfg = configs(XLSTM)[1]
    p = S.init_mlstm(torch.Generator().manual_seed(3), cfg)
    x = t(_x(cfg, 2, 12))
    rec, _ = _stepwise(S.mlstm_decode, p, cfg, x, S.mlstm_cache(cfg, 2, CPU))
    close(S.mlstm_train(p, cfg, x), rec.numpy(), 5e-3)


def test_mlstm_against_the_reference():
    """``mlstm_train`` within 1e-5, and 12 ``mlstm_decode`` steps (the
    first from ``m = -inf``: a forget weight of 0, not NaN) with the state
    after them within 1e-5."""
    rcfg, pcfg, rp, p = _block(RS.init_mlstm, XLSTM, 3)
    x = _x(pcfg, 2, 12)
    close(S.mlstm_train(p, pcfg, t(x)), RS.mlstm_train(rp, rcfg, x), 1e-5)
    rcache = RS.mlstm_cache(rcfg, 2)
    want = []
    for i in range(12):
        o, rcache = RS.mlstm_decode(rp, rcfg, x[:, i:i + 1], rcache)
        want.append(np.asarray(o[:, 0]))
    got, cache = _stepwise(S.mlstm_decode, p, pcfg, t(x),
                           S.mlstm_cache(pcfg, 2, CPU))
    assert bool(torch.isfinite(got).all())
    close(got, np.stack(want, 1), 1e-5)
    for name in ("C", "n", "m", "conv"):
        close(cache[name], rcache[name], 1e-5)


@pytest.mark.parametrize("l,chunk", [(40, 8), (40, 16), (33, 64)])
def test_mlstm_chunkwise_matches_parallel(l, chunk):
    """``mlstm_train`` past ``mlstm_chunk`` (the chunkwise form; 40 tokens
    in chunks of 16 pads, 33 in one chunk of 64) against the parallel form
    within 1e-4, and against the reference's chunkwise form within 1e-5."""
    rcfg, pcfg, rp, p = _block(RS.init_mlstm, XLSTM, 5)
    x = _x(pcfg, 2, l)
    parallel = S.mlstm_train(p, pcfg, t(x))
    rcfg = dataclasses.replace(rcfg, mlstm_chunk=min(chunk, l - 1))
    pcfg = dataclasses.replace(pcfg, mlstm_chunk=min(chunk, l - 1))
    got = S.mlstm_train(p, pcfg, t(x))
    close(got, parallel.numpy(), 1e-4)
    close(got, RS.mlstm_train(rp, rcfg, x), 1e-5)


# ------------------------------------------------------------------ sLSTM

def test_slstm_against_the_reference():
    """``slstm_train`` (the per-token loop) within 1e-5; 12
    ``slstm_decode`` steps equal its outputs within 1e-5 and the
    reference's, with the state after them."""
    rcfg, pcfg, rp, p = _block(RS.init_slstm, XLSTM, 6)
    x = _x(pcfg, 2, 12)
    train = S.slstm_train(p, pcfg, t(x))
    close(train, RS.slstm_train(rp, rcfg, x), 1e-5)
    rcache = RS.slstm_cache(rcfg, 2)
    for i in range(12):
        _, rcache = RS.slstm_decode(rp, rcfg, x[:, i:i + 1], rcache)
    got, cache = _stepwise(S.slstm_decode, p, pcfg, t(x),
                           S.slstm_cache(pcfg, 2, CPU))
    close(got, train.numpy(), 1e-5)
    for name in ("c", "n", "h", "m"):
        close(cache[name], rcache[name], 1e-5)


# ------------------------------------------------------------------ Mamba

def test_mamba_train_matches_stepwise():
    """The port's own ``mamba_train`` against its ``mamba_decode`` steps,
    within the reference's 5e-3 (``tests/test_models.py:152``)."""
    cfg = configs(JAMBA)[1]
    p = S.init_mamba(torch.Generator().manual_seed(4), cfg)
    x = t(_x(cfg, 2, 9))
    rec, _ = _stepwise(S.mamba_decode, p, cfg, x, S.mamba_cache(cfg, 2, CPU))
    close(S.mamba_train(p, cfg, x), rec.numpy(), 5e-3)


def test_mamba_against_the_reference():
    """``mamba_train`` and 9 ``mamba_decode`` steps (with the state after
    them) within 1e-5 of the reference's."""
    rcfg, pcfg, rp, p = _block(RS.init_mamba, JAMBA, 4)
    x = _x(pcfg, 2, 9)
    close(S.mamba_train(p, pcfg, t(x)), RS.mamba_train(rp, rcfg, x), 1e-5)
    rcache = RS.mamba_cache(rcfg, 2)
    want = []
    for i in range(9):
        o, rcache = RS.mamba_decode(rp, rcfg, x[:, i:i + 1], rcache)
        want.append(np.asarray(o[:, 0]))
    got, cache = _stepwise(S.mamba_decode, p, pcfg, t(x),
                           S.mamba_cache(pcfg, 2, CPU))
    close(got, np.stack(want, 1), 1e-5)
    close(cache["h"], rcache["h"], 1e-5)
    close(cache["conv"], rcache["conv"], 1e-5)


def _scan_inputs():
    b, l, di, ds = 2, 40, 8, 4
    rng = np.random.default_rng(0)
    return (rng.normal(size=(b, l, di)).astype(np.float32),
            (rng.random(size=(b, l, di)) * 0.1).astype(np.float32),
            -(rng.random(size=(di, ds)) + 0.5).astype(np.float32),
            rng.normal(size=(b, l, ds)).astype(np.float32),
            rng.normal(size=(b, l, ds)).astype(np.float32))


@pytest.mark.parametrize("chunk", [7, 8, 40, 64])
def test_selective_scan_against_the_reference(chunk):
    """The port's scan at chunks of 7 (the reference's padding path), 8,
    40 and 64 against the reference's at 40 within
    ``test_selective_scan_chunking_invariant``'s 1e-4 / 1e-5; the port's
    result is the same for every chunk, bit for bit."""
    args = _scan_inputs()
    want = RS.selective_scan(*map(jnp.asarray, args), chunk=40)
    got = S.selective_scan(*map(t, args), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    assert torch.equal(got, S.selective_scan(*map(t, args), chunk=40))


# ------------------------------------------------------------------ xLSTM

@pytest.mark.parametrize("mlstm_chunk", [0, 8])
def test_xlstm_apply_and_decode_against_the_reference(mlstm_chunk):
    """``apply`` over 16 tokens (with ``mlstm_chunk`` 8: the chunkwise
    form in every mLSTM layer), and 10 ``decode_step``s: logits and every
    state within 1e-4 of the reference's."""
    rcfg, pcfg, ref, params = world(XLSTM, mlstm_chunk=mlstm_chunk)
    rbatch, batch_ = batch(pcfg, 2, 16)
    want, _ = ref_fns(rcfg)[0](ref, rcfg, rbatch)
    got, aux = X.apply(params, pcfg, batch_)
    close(got, want, 1e-4)
    assert float(aux) == 0.0
    want, rcache = ref_decode(rcfg, ref, rbatch, 12, 10)
    got, cache = port_decode(pcfg, params, batch_, 12, 10)
    close(got, want, 1e-4)
    rflat = flat(rcache)
    for name, v in flat(cache).items():
        close(v, rflat[name], 1e-4)


def test_xlstm_decode_matches_teacher_forced():
    err = decode_vs_teacher_forced(XLSTM)
    assert err < 1e-3, err


# Relative L2 of one bf16 block (its train form over 16 tokens, and 16
# decode steps) against the reference's unjitted run with its silu rounded
# once (``silu_once``): unjitted, XLA rounds every bf16 op as written, as
# torch does; jitted, it keeps excess precision inside its fusions (the
# selective scan's bf16 ``dt * B * x`` comes out unrounded). Measured at
# seeds 8, 9 and 10: at most 4.82e-4 (mamba's train form at seed 10; the
# mLSTM 2.04e-4, its chunkwise form 5.11e-5, the sLSTM 0), most cases 0:
# the rest are rare one-step flips of bf16 products at near-ties, which the
# gates carry on. One bf16 rounding added or dropped over a whole tensor
# moves it by about 1e-3 (a bf16 step is 3.9e-3): four misplaced casts
# tried in a scratch copy (mamba's ``dt * B * x`` in f32, its ``dt`` not
# rounded to bf16, the parallel and the chunkwise mLSTM's ``s @ v`` in
# f32) each fail a case.
BF16_BLOCK_BOUND = 7.5e-4


@pytest.mark.parametrize("block", ["mlstm", "mlstm_chunkwise", "slstm",
                                   "mamba"])
@pytest.mark.parametrize("seed", [8, 10])
def test_bf16_blocks_against_the_reference(block, seed, monkeypatch):
    """(``mlstm_chunkwise``: the mLSTM's train form in chunks of 8.)"""
    monkeypatch.setattr(jax.nn, "silu", silu_once)
    chunk = 8 if block == "mlstm_chunkwise" else 0
    block = block.split("_")[0]
    rcfg, pcfg = configs(JAMBA if block == "mamba" else XLSTM,
                         mlstm_chunk=chunk, **BF16)
    rp = getattr(RS, f"init_{block}")(jax.random.PRNGKey(seed), rcfg)
    p = {k: t(np.asarray(v, np.float32)).to(
        torch.float32 if v.dtype == jnp.float32 else torch.bfloat16)
        for k, v in rp.items()}
    x = np.asarray(jnp.asarray(np.random.default_rng(seed).normal(
        size=(2, 16, pcfg.d_model)), jnp.bfloat16), np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    with jax.disable_jit():
        want = [getattr(RS, f"{block}_train")(rp, rcfg, xj)]
        rc, outs = getattr(RS, f"{block}_cache")(rcfg, 2), []
        for i in range(16):
            o, rc = getattr(RS, f"{block}_decode")(rp, rcfg, xj[:, i:i + 1],
                                                   rc)
            outs.append(o[:, 0])
        want.append(jnp.stack(outs, 1))
    got = [getattr(S, f"{block}_train")(p, pcfg, t(x).bfloat16()),
           _stepwise(getattr(S, f"{block}_decode"), p, pcfg,
                     t(x).bfloat16(),
                     getattr(S, f"{block}_cache")(pcfg, 2, CPU))[0]]
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert rel_l2(g, w) <= BF16_BLOCK_BOUND, rel_l2(g, w)


# The bf16 xLSTM against the reference's bf16 run, relative L2 of the
# logits of a 16-token apply and of 10 decode steps (``pytest -s`` prints
# them). New bf16 paths: the mLSTM's bf16 ``s @ v`` and bf16 division by
# its normaliser, the bf16 causal conv, the gates' f32 product of bf16
# activations, the sLSTM's bf16 recurrent product. Measured at the reduced
# xlstm-1.3b and the seeds below: as drawn 1.77e-1 (apply) and 6.74e-2
# (decode). With the reference's
# ``jax.nn.silu`` rounded once like ``F.silu`` (``silu_once``; every
# mLSTM and sLSTM block applies silu to bf16 values that feed the
# exponential gates) 1.07e-2 and 5.49e-3: XLA's five-op bf16 silu,
# amplified by the gates, is nearly the whole gap (the rest: the f32 gate
# products, summed in another order). Given the reference's q, k, v and
# gate logits, ``_mlstm_parallel`` gives its bf16 answer bit for bit.
BF16_XLSTM_BOUNDS = {
    "drawn": dict(apply=0.22, decode=0.085),
    "silu_once": dict(apply=1.4e-2, decode=7e-3),
}


@pytest.mark.parametrize("case", sorted(BF16_XLSTM_BOUNDS))
def test_xlstm_bf16_against_the_reference(case, monkeypatch):
    """The reduced xlstm-1.3b in bf16 against the reference's bf16 run
    (with ``silu_once``: unjitted, its silu rounded once), each gap within
    its bound above."""
    if case == "silu_once":
        monkeypatch.setattr(jax.nn, "silu", silu_once)
    gaps = bf16_gaps(XLSTM, X.apply, eager=case == "silu_once")
    print(case, gaps)
    bounds = BF16_XLSTM_BOUNDS[case]
    assert all(gaps[n] <= b for n, b in bounds.items()), (gaps, bounds)
