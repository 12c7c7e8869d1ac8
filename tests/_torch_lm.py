"""Shared helpers of the LM tower's parity tests (``tests/test_torch_moe.py``,
``test_torch_ssm.py``, ``test_torch_encdec.py``, ``test_torch_hybrid.py``,
``test_torch_train.py``, ``test_torch_train_step.py``): the reference's
params at a ``reduced_config`` carried into the port with
``convert.lm_params``, numpy-seeded batches (with labels for training),
leaves by path, and a decode run of both packages. The reference runs its model functions jitted, as
``tests/test_torch_models.py`` does."""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as RR
from repro.models import encdec as RE
from repro.models.model import build_model as ref_build
from repro_torch import convert
from repro_torch.configs import registry as PR
from repro_torch.models import build_model
from repro_torch.models import encdec as E

CPU = torch.device("cpu")
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


def t(a):
    return torch.as_tensor(np.array(a))


def close(got, want, tol):
    got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def rel_l2(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got.detach().float().numpy() - want)
                 / np.linalg.norm(want))


def configs(arch, **overrides):
    """(reference cfg, port cfg) at ``reduced_config(arch)`` with the same
    overrides."""
    return (dataclasses.replace(RR.reduced_config(arch), **overrides),
            dataclasses.replace(PR.reduced_config(arch), **overrides))


@functools.cache
def ref_fns(rcfg):
    """The reference's jitted apply and decode_step at ``rcfg``, and its
    encode_prefill."""
    api = ref_build(rcfg)
    return (jax.jit(api.apply, static_argnums=1),
            jax.jit(api.decode_step, static_argnums=1),
            jax.jit(RE.encode_prefill, static_argnums=1))


def world(arch, seed=2, **overrides):
    """(reference cfg, port cfg, reference params, port params): the
    reference's ``init_params`` carried over with ``convert.lm_params``."""
    rcfg, pcfg = configs(arch, **overrides)
    arrays = jax.tree.map(np.asarray, ref_build(rcfg).init_params(
        jax.random.PRNGKey(seed), rcfg))
    return (rcfg, pcfg, jax.tree.map(jnp.asarray, arrays),
            convert.lm_params(arrays, pcfg, CPU))


def batch(cfg, b, s, seed=0):
    """(reference batch, port batch) of tokens (and mel frames for
    encdec) from a numpy seed."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)
                                     ).astype(np.int32)}
    if cfg.family == "encdec":
        arrays["frames"] = rng.normal(size=(b, cfg.n_frames, cfg.d_model)
                                      ).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: t(v) for k, v in arrays.items()})


def ref_decode(rcfg, ref, rbatch, max_len, steps, eager=False):
    """The reference's logits [steps, B, Vp] and its final cache, one
    decode step per token of ``rbatch`` (``eager``: its functions
    unjitted)."""
    _, decode, prefill = ref_fns(rcfg)
    if eager:
        decode, prefill = ref_build(rcfg).decode_step, RE.encode_prefill
    cache = ref_build(rcfg).init_cache(rcfg, rbatch["tokens"].shape[0],
                                       max_len)
    if rcfg.family == "encdec":
        cache = prefill(ref, rcfg, rbatch["frames"], cache)
    out = []
    for i in range(steps):
        logits, cache = decode(ref, rcfg, {"tokens": rbatch["tokens"][:, i]},
                               cache)
        out.append(np.asarray(logits))
    return np.stack(out), jax.tree.map(np.asarray, cache)


def port_decode(pcfg, params, batch_, max_len, steps):
    """The port's logits [steps, B, Vp] and its final cache, as
    ``ref_decode``."""
    api = build_model(pcfg)
    cache = api.init_cache(pcfg, batch_["tokens"].shape[0], max_len, CPU)
    if pcfg.family == "encdec":
        cache = E.encode_prefill(params, pcfg, batch_["frames"], cache)
    out = []
    for i in range(steps):
        logits, cache = api.decode_step(params, pcfg,
                                        {"tokens": batch_["tokens"][:, i]},
                                        cache)
        assert logits.dtype == torch.float32
        out.append(logits)
    return torch.stack(out), cache


def flat(tree, prefix="") -> dict:
    """A nested dict's leaves by path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# the reference's activations as imported, before a test patches them
_SILU, _GELU = jax.nn.silu, jax.nn.gelu


def silu_once(x):
    """bf16 ``silu`` rounded once, from f32, as ``F.silu`` rounds it. XLA's
    CPU backend expands ``jax.nn.silu`` into five ops and rounds a bf16
    input after each; a test patches this in for ``jax.nn.silu`` (and runs
    the reference eagerly, past its jit cache) to split that rounding from
    the rest of a bf16 gap."""
    return _SILU(x.astype(jnp.float32)).astype(x.dtype)


def gelu_once(x, approximate=True):
    """bf16 GELU rounded once, from f32, as ``F.gelu`` rounds it (the
    counterpart of ``silu_once`` for ``jax.nn.gelu``)."""
    return _GELU(x.astype(jnp.float32), approximate=approximate).astype(
        x.dtype)


def bf16_gaps(arch, apply_fn, eager: bool, seed=6, **overrides) -> dict:
    """Relative L2 of the port's bf16 logits against the reference's bf16
    run: a 16-token ``apply`` and 10 decode steps. ``eager`` runs the
    reference unjitted."""
    rcfg, pcfg, ref, params = world(arch, **BF16, **overrides)
    rbatch, batch_ = batch(pcfg, 2, 16, seed=seed)
    got, _ = apply_fn(params, pcfg, batch_)
    assert got.dtype == torch.bfloat16
    with (jax.disable_jit() if eager else contextlib.nullcontext()):
        want, _ = (ref_build(rcfg).apply if eager else ref_fns(rcfg)[0])(
            ref, rcfg, rbatch)
        gaps = {"apply": rel_l2(got, want)}
        want, _ = ref_decode(rcfg, ref, rbatch, 12, 10, eager=eager)
    got, _ = port_decode(pcfg, params, batch_, 12, 10)
    gaps["decode"] = rel_l2(got, want)
    return gaps


def decode_vs_teacher_forced(arch, **overrides) -> float:
    """The port's own init: the largest gap between decode logits and
    ``apply``'s at every position of 2 x 10 tokens."""
    cfg = dataclasses.replace(PR.reduced_config(arch), **overrides)
    api = build_model(cfg)
    params = api.init_params(2, cfg, CPU)
    _, batch_ = batch(cfg, 2, 10, seed=5)
    tf_logits, _ = api.apply(params, cfg, batch_)
    logits, _ = port_decode(cfg, params, batch_, 12, 10)
    return float((logits - tf_logits.transpose(0, 1)).abs().max())


def train_batch(cfg, b, s, seed=0) -> dict:
    """Tokens and labels (mel frames for encdec, patch embeddings for vlm)
    from a numpy seed, as numpy arrays."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(b, cfg.n_frames, cfg.d_model)
                                   ).astype(np.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.normal(size=(b, cfg.n_patches, cfg.d_model)
                                         ).astype(np.float32)
    return out


def by_path(tree) -> dict:
    """The leaves of either package's tree as {path: numpy}, the paths
    joined with ``/`` in the reference's flatten order."""
    from repro_torch.utils.tree import leaves_with_paths
    return {k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))
            for k, v in leaves_with_paths(jax.tree.map(
                lambda a: a if isinstance(a, torch.Tensor) else np.asarray(a),
                tree))}


def max_gap(a: dict, b: dict) -> float:
    """The largest absolute difference of two ``by_path`` dicts (f32)."""
    assert a.keys() == b.keys()
    return max(float(np.abs(a[k].astype(np.float32)
                            - b[k].astype(np.float32)).max()) for k in a)


def rel_gap(a, b, floor=0.0) -> float:
    """Relative L2 of ``a`` against ``b`` (whose norm is floored)."""
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), floor))
