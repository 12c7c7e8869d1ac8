"""The hybrid family of the port (``models/hybrid.py``: Mamba + attention
1:7, MoE every second layer; jamba's reduced config, one interleave group)
against the JAX reference on the CPU.

The reference's reduced jamba is the slowest model here to trace, so its
outputs are computed once per module (``ref_run``). Tolerances: 1e-4 for
a model's logits, caches and states, 1e-3 for decode against teacher-
forced (the reference's own bound, at ``capacity_factor = E / k`` so that
no token drops), and the measured bf16 gaps of ``BF16_HYBRID_BOUNDS``.
"""
import numpy as np
import pytest
import torch

from _torch_lm import (batch, bf16_gaps, close, configs,
                       decode_vs_teacher_forced,
                       flat, port_decode, ref_decode, ref_fns, world)
from repro_torch.models import hybrid as H

ARCH = "jamba-1.5-large-398b"
S = 80          # past attn_chunk (64): the attention layer takes flash


@pytest.fixture(scope="module")
def ref_run():
    """The reduced jamba's params in both packages, one batch of 2 x 80
    tokens, and the reference's ``apply`` (logits, aux) and 10 decode
    steps (logits, final cache) on it."""
    rcfg, pcfg, ref, params = world(ARCH)
    rbatch, batch_ = batch(pcfg, 2, S)
    logits, aux = ref_fns(rcfg)[0](ref, rcfg, rbatch)
    steps, cache = ref_decode(rcfg, ref, rbatch, 12, 10)
    return dict(pcfg=pcfg, params=params, batch=batch_,
                logits=np.asarray(logits), aux=float(aux), steps=steps,
                cache=cache)


def test_apply_against_the_reference(ref_run):
    """``apply`` over 80 tokens (flash in the attention layer, the MoE
    layers at the published capacity factor): logits within 1e-4 and the
    summed aux loss within 1e-5."""
    got, aux = H.apply(ref_run["params"], ref_run["pcfg"], ref_run["batch"])
    close(got, ref_run["logits"], 1e-4)
    np.testing.assert_allclose(float(aux), ref_run["aux"], rtol=1e-5)


def test_decode_against_the_reference(ref_run):
    """10 ``decode_step``s: logits, the attention layer's KV caches and
    every mamba layer's conv history and SSM state within 1e-4."""
    got, cache = port_decode(ref_run["pcfg"], ref_run["params"],
                             ref_run["batch"], 12, 10)
    close(got, ref_run["steps"], 1e-4)
    want = flat(ref_run["cache"])
    got = flat(cache)
    assert got.keys() == want.keys()
    for name, v in got.items():
        close(v, want[name], 1e-4)


def test_decode_matches_teacher_forced():
    err = decode_vs_teacher_forced(ARCH, capacity_factor=4.0)
    assert err < 1e-3, err


# The bf16 jamba against the reference's bf16 run, relative L2 of the
# logits of a 16-token apply and of 10 decode steps (``pytest -s`` prints
# them; capacity_factor E / k: no drops). New bf16 paths: the selective
# scan's gates (``dt * B * x`` formed in bf16, then f32), the bf16 causal
# conv, the f32 conv history of the mamba decode, the router softmax.
# Measured at the reduced jamba and the seeds below: 6.04e-2 (apply) and
# 6.85e-2 (decode), about six times the dense model's gap. Its blocks hold
# to the reference one by one (``test_torch_ssm.py::test_bf16_blocks_
# against_the_reference``, ``test_torch_moe.py``); through eight layers the
# mamba recurrences and the router's top-2 (a flipped choice swaps an
# expert) carry every rounding flip on.
BF16_HYBRID_BOUNDS = dict(apply=7.5e-2, decode=8.5e-2)


def test_bf16_against_the_reference():
    """The reduced jamba in bf16 against the reference's bf16 run, each
    gap within its bound above."""
    gaps = bf16_gaps(ARCH, H.apply, eager=False, capacity_factor=4.0)
    print(gaps)
    assert all(gaps[n] <= b for n, b in BF16_HYBRID_BOUNDS.items()), gaps


def test_cache_layout():
    """``init_cache``: KV caches for the one attention layer a group,
    conv history and SSM state stacked [groups, n] for the four MoE and
    three dense mamba layers, on the CPU when asked."""
    cfg = configs(ARCH)[1]
    cache = H.init_cache(cfg, 2, 12, "cpu")
    di = cfg.ssm_expand * cfg.d_model
    assert cache["k"].shape == (1, 2, 12, cfg.n_kv_heads, cfg.head_dim_)
    assert cache["mamba_moe"]["h"].shape == (1, 4, 2, di, cfg.ssm_d_state)
    assert cache["mamba_dense"]["conv"].shape == (1, 3, 2, cfg.ssm_conv - 1,
                                                  di)
    assert all(t.device == torch.device("cpu") for t in flat(cache).values())
