"""The LM tower's dense serving path of the port (``repro_torch.configs``,
``models/layers.py``, ``models/transformer.py``, ``models/model.py``,
``serve/serve_step.py``) against the JAX reference on the CPU, and
``build_model`` / ``init_params`` / ``convert.lm_params`` for every family
(the families' own paths: ``tests/test_torch_{moe,ssm,encdec,hybrid}.py``).

Inputs come from numpy seeds; the reference's ``init_params`` is carried
across with ``convert.lm_params``, one module-wide set per configuration.
The reference runs as ``tests/test_models.py`` runs it (eagerly, with its
step functions jitted). Tolerances: 1e-5 for one layer function, 1e-4 for
a whole model's logits and caches, 1e-3 for decode against teacher-forced
(the reference's own bound), exact for greedy tokens. In bf16 (the
served dtype), one bf16 step and 99.9% equal for a layer function, and
the measured gaps of ``BF16_MODEL_BOUNDS`` for the whole model.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as RB
from repro.configs import registry as RR
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.models.model import build_model as ref_build
from repro.serve import serve_step as RS
from repro_torch import convert
from repro_torch.configs import base as PB
from repro_torch.configs import registry as PR
from repro_torch.models import build_model, encdec
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve import make_decode_step, make_prefill_step

CPU = torch.device("cpu")
MODEL_ARCHS = ["qwen3-8b", "granite-34b", "qwen2-vl-7b"]


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, tol):
    got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------- configs

def _cfg_props(cfg):
    return (cfg.padded_vocab, cfg.head_dim_, cfg.q_groups, cfg.sub_quadratic,
            cfg.expert_ff(), str(cfg.pdtype).replace("torch.", ""),
            str(cfg.cdtype).replace("torch.", ""))


def _ref_props(cfg):
    return (cfg.padded_vocab, cfg.head_dim_, cfg.q_groups, cfg.sub_quadratic,
            cfg.expert_ff(), jnp.dtype(cfg.pdtype).name,
            jnp.dtype(cfg.cdtype).name)


@pytest.mark.parametrize("arch", sorted(RR.ARCHS))
def test_config_equals_the_reference(arch):
    """Every field and property of ``get_config`` and ``reduced_config``;
    the shape table and its ``applicable`` row."""
    assert sorted(PR.ARCHS) == sorted(RR.ARCHS)
    for port, ref in ((PR.get_config(arch), RR.get_config(arch)),
                      (PR.reduced_config(arch), RR.reduced_config(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert _cfg_props(port) == _ref_props(ref)
    assert {k: dataclasses.asdict(v) for k, v in PB.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in RB.SHAPES.items()}
    for name in RB.SHAPES:
        assert PB.applicable(PR.get_config(arch), PB.SHAPES[name]) == \
            RB.applicable(RR.get_config(arch), RB.SHAPES[name])
    with pytest.raises(KeyError, match="unknown arch"):
        PR.get_config("gpt-5")


# ----------------------------------------------------------------- layers

RNG = np.random.default_rng(20)


def _normal(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def test_norms():
    x, w, b = _normal(3, 5, 48), _normal(48), _normal(48)
    _close(L.rms_norm(_t(x), _t(w), 1e-6), RL.rms_norm(x, w, 1e-6), 1e-5)
    _close(L.layer_norm(_t(x), _t(w), _t(b)), RL.layer_norm(x, w, b), 1e-5)


def test_rope_and_mrope():
    pos = RNG.integers(0, 4000, (2, 7)).astype(np.int32)
    _close(L.rope_freqs(32, 1e6), RL.rope_freqs(32, 1e6), 1e-5)
    cos, sin = L.rope_cos_sin(_t(pos), 32, 1e6)
    want_cos, want_sin = RL.rope_cos_sin(jnp.asarray(pos), 32, 1e6)
    _close(cos, want_cos, 1e-5)
    _close(sin, want_sin, 1e-5)
    for x in (_normal(2, 7, 2, 3, 32), _normal(2, 7, 2, 32)):
        _close(L.apply_rope(_t(x), cos, sin),
               RL.apply_rope(x, want_cos, want_sin), 1e-5)
    pos3 = RNG.integers(0, 300, (2, 7, 3)).astype(np.int32)
    cos, sin = L.mrope_cos_sin(_t(pos3), 32, (4, 6, 6), 1e6)
    want_cos, want_sin = RL.mrope_cos_sin(jnp.asarray(pos3), 32, (4, 6, 6),
                                          1e6)
    _close(cos, want_cos, 1e-5)
    _close(sin, want_sin, 1e-5)


def _qkv(b, sq, sk, hkv=2, g=2, dh=16):
    return (_normal(b, sq, hkv, g, dh), _normal(b, sk, hkv, dh),
            _normal(b, sk, hkv, dh))


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (False, 0),
                                             (True, 5)])
def test_full_attention(causal, q_offset):
    q, k, v = _qkv(2, 12, 17)
    got = L.full_attention(_t(q), _t(k), _t(v), causal=causal,
                           q_offset=q_offset)
    _close(got, RL.full_attention(q, k, v, causal=causal, q_offset=q_offset),
           1e-5)


@pytest.mark.parametrize("chunk", [16, 24, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention(chunk, causal):
    """64 keys in chunks of 16 and 64, and of 24 (the padding branch)."""
    q, k, v = _qkv(2, 64, 64)
    got = L.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                            kv_chunk=chunk)
    _close(got, RL.flash_attention(q, k, v, causal=causal, kv_chunk=chunk),
           1e-5)
    _close(got, RL.full_attention(q, k, v, causal=causal), 2e-5)


def test_decode_attention():
    """Lengths inside the cache and at a full cache."""
    q, k, v = _qkv(3, 1, 32)
    for lens in ([20, 1, 31], [32, 32, 32]):
        lens = np.asarray(lens, np.int32)
        got = L.decode_attention(_t(q), _t(k), _t(v), _t(lens))
        _close(got, RL.decode_attention(q, k, v, jnp.asarray(lens)), 1e-5)


def test_mlps():
    x = _normal(2, 5, 32)
    wg, wu, wd = _normal(32, 64, scale=0.2), _normal(32, 64, scale=0.2), \
        _normal(64, 32, scale=0.2)
    bu, bd = _normal(64), _normal(32)
    _close(L.swiglu(_t(x), _t(wg), _t(wu), _t(wd)),
           RL.swiglu(x, wg, wu, wd), 1e-5)
    _close(L.gelu_mlp(_t(x), _t(wu), _t(bu), _t(wd), _t(bd)),
           RL.gelu_mlp(x, wu, bu, wd, bd), 1e-5)


# ----------------------------------------------------------------- models

_ref_apply = jax.jit(RT.apply, static_argnums=1)
_ref_features = jax.jit(RT.features, static_argnums=1)
_ref_decode = jax.jit(RT.decode_step, static_argnums=1)


@functools.cache
def _world(arch, bias=False):
    """(reference cfg, port cfg, reference params, port params) at
    ``reduced_config(arch)``; with ``bias``, ``use_bias=True`` and nonzero
    biases drawn from a numpy seed."""
    rcfg, pcfg = RR.reduced_config(arch), PR.reduced_config(arch)
    if bias:
        rcfg = dataclasses.replace(rcfg, use_bias=True)
        pcfg = dataclasses.replace(pcfg, use_bias=True)
    arrays = jax.tree.map(np.asarray,
                          RT.init_params(jax.random.PRNGKey(2), rcfg))
    if bias:
        rng = np.random.default_rng(3)
        for name in ("bq", "bk", "bv", "bo"):
            a = arrays["blocks"][name]
            arrays["blocks"][name] = (rng.normal(size=a.shape) * 0.1
                                      ).astype(np.float32)
    ref = jax.tree.map(jnp.asarray, arrays)
    return rcfg, pcfg, ref, convert.lm_params(arrays, pcfg, CPU)


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)
                                    ).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = (rng.normal(
            size=(b, min(cfg.n_patches, s), cfg.d_model)) * 0.1
        ).astype(np.float32)
        batch["positions"] = np.broadcast_to(
            np.arange(s, dtype=np.int32)[None, :, None], (b, s, 3)).copy()
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: _t(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch,bias,s", [
    ("qwen3-8b", False, 16), ("granite-34b", False, 16),
    ("qwen2-vl-7b", False, 16), ("qwen3-8b", True, 16),
    ("qwen3-8b", False, 80)])
def test_apply_and_features(arch, bias, s):
    """Teacher-forced logits and features; s = 80 > attn_chunk = 64 takes
    flash_attention (with its padding) inside ``apply``; the prefill step
    returns ``apply``'s logits."""
    rcfg, pcfg, ref, params = _world(arch, bias)
    rbatch, batch = _batch(pcfg, 2, s)
    want, _ = _ref_apply(ref, rcfg, rbatch)
    got, aux = T.apply(params, pcfg, batch)
    assert got.shape == want.shape and float(aux) == 0.0
    _close(got, want, 1e-4)
    _close(T.features(params, pcfg, batch)[0],
           _ref_features(ref, rcfg, rbatch)[0], 1e-4)
    assert torch.equal(make_prefill_step(pcfg)(params, batch), got)
    assert torch.equal(T.prefill(params, pcfg, batch, None)[0], got)


@pytest.mark.parametrize("arch,max_len", [
    ("qwen3-8b", 12), ("granite-34b", 12), ("qwen2-vl-7b", 12),
    ("qwen3-8b", 6)])
def test_decode_steps(arch, max_len):
    """Ten decode steps: logits, both caches and the lengths after each.
    At max_len 6 the last four steps write past the end, where the
    reference clamps the row to the last one."""
    rcfg, pcfg, ref, params = _world(arch)
    toks = np.random.default_rng(4).integers(0, pcfg.vocab_size, (2, 10)
                                             ).astype(np.int32)
    rcache = RT.init_cache(rcfg, 2, max_len)
    cache = T.init_cache(pcfg, 2, max_len, CPU)
    for t in range(10):
        want, rcache = _ref_decode(ref, rcfg, {"tokens": toks[:, t]}, rcache)
        got, cache = T.decode_step(params, pcfg, {"tokens": _t(toks[:, t])},
                                   cache)
        assert got.dtype == torch.float32
        _close(got, want, 1e-4)
        _close(cache["k"], rcache["k"], 1e-4)
        _close(cache["v"], rcache["v"], 1e-4)
        assert cache["len"].tolist() == np.asarray(rcache["len"]).tolist()


def test_greedy_tokens_equal_the_reference():
    """``make_decode_step`` greedy: 12 tokens fed back, each step's token
    and logits against the reference's step."""
    rcfg, pcfg, ref, params = _world("qwen3-8b")
    ref_step = jax.jit(RS.make_decode_step(rcfg), static_argnums=())
    step = make_decode_step(pcfg)
    rcache, cache = RT.init_cache(rcfg, 3, 16), T.init_cache(pcfg, 3, 16,
                                                             CPU)
    rtok = jnp.asarray([5, 77, 300], jnp.int32)
    tok = _t(np.asarray(rtok))
    got_all, want_all = [], []
    for _ in range(12):
        rtok, rlogits, rcache = ref_step(ref, rcache, rtok)
        tok, logits, cache = step(params, cache, tok)
        assert logits.shape == (3, pcfg.vocab_size)
        _close(logits, rlogits, 1e-4)
        want_all.append(np.asarray(rtok))
        got_all.append(tok.numpy())
    np.testing.assert_array_equal(np.stack(got_all), np.stack(want_all))


# ------------------------------------------------------------------- bf16
#
# The served configuration runs in bf16, where each cast the port places
# like the reference (scores and flash's ``p @ v`` up-cast to f32, the
# probabilities cast back to bf16, norms and RoPE in f32 and back, the
# decode logits' f32) changes the result. One layer function in bf16
# gives the reference's bf16 answer bit for bit, up to a rare one-step
# flip where the f32 sums of the two libraries round apart; a dropped or
# misplaced cast moves far more of the elements by a step. A whole
# model differs more: XLA's CPU backend expands the bf16 ``silu`` into
# five ops rounded to bf16 one by one (up to 2 bf16 steps off the true
# value; torch's ``F.silu`` rounds once, within half a step), and each
# flip grows through the layers. So the model is held twice: with the
# weights as drawn, at the measured bf16 gap, and with the FFN's gate
# zeroed (the FFN adds exact zeros in both), where the rest of the model
# gives the reference's answer up to flips in the flash path.

BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


def _bf16(*shape):
    """Normal draws rounded to bf16, as f32 arrays (exact in bf16)."""
    return np.asarray(jnp.asarray(_normal(*shape), jnp.bfloat16), np.float32)


def _steps_apart(got, want):
    """Per element, how many bf16 steps ``got`` (a bf16 tensor) lies from
    ``want`` (an array of bf16 values)."""
    def key(a):
        bits = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
        return np.where(bits < 0, -(bits & 0x7FFFFFFF), bits) >> 16
    return np.abs(key(got.float().numpy()) - key(want))


def _bf16_layer(case):
    """(port's bf16 result, reference's) of one layer function."""
    tb, jb = (lambda a: _t(a).bfloat16()), (lambda a: jnp.asarray(
        a, jnp.bfloat16))
    if case == "rms_norm":
        x, w = _bf16(3, 5, 48), _normal(48)
        return L.rms_norm(tb(x), _t(w)), RL.rms_norm(jb(x), w)
    if case == "rope":
        pos = RNG.integers(0, 4000, (2, 7)).astype(np.int32)
        x = _bf16(2, 7, 2, 3, 32)
        cos, sin = L.rope_cos_sin(_t(pos), 32, 1e6)
        want_cos, want_sin = RL.rope_cos_sin(jnp.asarray(pos), 32, 1e6)
        return (L.apply_rope(tb(x), cos, sin),
                RL.apply_rope(jb(x), want_cos, want_sin))
    if case.startswith("decode"):
        q, k, v = _bf16(3, 1, 2, 2, 16), _bf16(3, 32, 2, 16), \
            _bf16(3, 32, 2, 16)
        lens = np.asarray([32, 32, 32] if case == "decode_full"
                          else [20, 1, 31], np.int32)
        return (L.decode_attention(tb(q), tb(k), tb(v), _t(lens)),
                RL.decode_attention(jb(q), jb(k), jb(v), jnp.asarray(lens)))
    kind, arg = case.split("_")
    sq, sk = (12, 17) if kind == "full" else (80, 80)
    q, k, v = _bf16(2, sq, 2, 2, 16), _bf16(2, sk, 2, 16), _bf16(2, sk, 2, 16)
    if kind == "full":
        kw = dict(causal=arg != "open", q_offset=5 if arg == "offset" else 0)
        return (L.full_attention(tb(q), tb(k), tb(v), **kw),
                RL.full_attention(jb(q), jb(k), jb(v), **kw))
    chunk, causal = (24, False) if arg == "open" else (int(arg), True)
    return (L.flash_attention(tb(q), tb(k), tb(v), causal=causal,
                              kv_chunk=chunk),
            RL.flash_attention(jb(q), jb(k), jb(v), causal=causal,
                               kv_chunk=chunk))


@pytest.mark.parametrize("case", [
    "rms_norm", "rope", "full_causal", "full_open", "full_offset",
    "flash_16", "flash_24", "flash_64", "flash_open", "decode",
    "decode_full"])
def test_bf16_layers_equal_the_reference(case):
    """In bf16, at most one bf16 step from the reference's answer and at
    least 99.9% of the elements equal to it (each dropped or misplaced
    cast of the attention functions, norms and RoPE fails this). Flash
    runs 80 keys in chunks of 16, 24 and 64 (the last two padded)."""
    got, want = _bf16_layer(case)
    assert got.dtype == torch.bfloat16
    apart = _steps_apart(got, np.asarray(want, np.float32))
    assert apart.max() <= 1, apart.max()
    assert (apart == 0).mean() >= 0.999, (apart == 0).mean()


# relative L2 bounds of the bf16 model against the reference's bf16 run:
# logits of a 16-token apply (full attention), of an 80-token apply
# (flash), of 10 decode steps, and both caches after them (``pytest -s``
# prints the gaps). Measured at qwen3-8b's reduced config and the seeds
# below: as drawn 8.95e-3, 9.58e-3, 8.81e-3, 4.95e-3 and 4.57e-3; gate
# zeroed 0, 2.72e-3, 0, 3.8e-8 and 0. With the gate zeroed, each dropped
# or misplaced cast of the attention, norms, RoPE and decode logits
# fails a bound it reaches.
BF16_MODEL_BOUNDS = {
    "drawn": dict(full=1.2e-2, flash=1.25e-2, decode=1.2e-2, k=6e-3,
                  v=6e-3),
    "gate_zeroed": dict(full=1e-3, flash=4e-3, decode=1e-3, k=1e-3,
                        v=1e-3),
}


@functools.cache
def _bf16_world(weights):
    rcfg = dataclasses.replace(RR.reduced_config("qwen3-8b"), **BF16)
    pcfg = dataclasses.replace(PR.reduced_config("qwen3-8b"), **BF16)
    arrays = jax.tree.map(np.asarray,
                          RT.init_params(jax.random.PRNGKey(2), rcfg))
    if weights == "gate_zeroed":
        arrays["blocks"]["gate"] = np.zeros_like(arrays["blocks"]["gate"])
    ref = jax.tree.map(jnp.asarray, arrays)
    return rcfg, pcfg, ref, convert.lm_params(arrays, pcfg, CPU)


def _rel_l2(got, want):
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got.float().numpy() - want)
                 / np.linalg.norm(want))


@pytest.mark.parametrize("weights", sorted(BF16_MODEL_BOUNDS))
def test_bf16_model_against_the_reference(weights):
    """``apply`` over 16 and 80 tokens and 10 ``decode_step``s in bf16
    against the reference's bf16 run, each within its bound above."""
    rcfg, pcfg, ref, params = _bf16_world(weights)
    toks = np.random.default_rng(6).integers(0, pcfg.vocab_size, (2, 80)
                                             ).astype(np.int32)
    gaps = {}
    for name, s in (("full", 16), ("flash", 80)):
        want, _ = _ref_apply(ref, rcfg, {"tokens": jnp.asarray(toks[:, :s])})
        got, _ = T.apply(params, pcfg, {"tokens": _t(toks[:, :s])})
        assert got.dtype == torch.bfloat16
        gaps[name] = _rel_l2(got, want)
    rcache = RT.init_cache(rcfg, 2, 12)
    cache = T.init_cache(pcfg, 2, 12, CPU)
    got_all, want_all = [], []
    for t in range(10):
        want, rcache = _ref_decode(ref, rcfg, {"tokens": toks[:, t]}, rcache)
        got, cache = T.decode_step(params, pcfg, {"tokens": _t(toks[:, t])},
                                   cache)
        assert got.dtype == torch.float32
        got_all.append(got)
        want_all.append(np.asarray(want))
    gaps["decode"] = _rel_l2(torch.stack(got_all), np.stack(want_all))
    gaps["k"] = _rel_l2(cache["k"], rcache["k"])
    gaps["v"] = _rel_l2(cache["v"], rcache["v"])
    bounds = BF16_MODEL_BOUNDS[weights]
    print(weights, gaps)
    assert all(gaps[name] <= bounds[name] for name in bounds), (gaps, bounds)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_decode_matches_teacher_forced(arch):
    """The port's own init: decode logits at every position within 1e-3
    of ``apply``'s, as tests/test_models.py holds the reference."""
    cfg = PR.reduced_config(arch)
    api = build_model(cfg)
    params = api.init_params(2, cfg, CPU)
    _, batch = _batch(cfg, 2, 10, seed=5)
    batch.pop("patch_embeds", None)   # decode embeds tokens only
    tf_logits, _ = api.apply(params, cfg, batch)
    cache = api.init_cache(cfg, 2, 12, CPU)
    errs = []
    for t in range(10):
        dl, cache = api.decode_step(
            params, cfg, {"tokens": batch["tokens"][:, t]}, cache)
        errs.append(float((dl - tf_logits[:, t]).abs().max()))
    assert max(errs) < 1e-3, errs


def test_sampling_draws_from_the_top_k_and_repeats():
    """temperature 0.7, top_k 5: every draw is among the step's 5 largest
    logits, more than one of them is drawn, and one generator seed gives
    the same draws again."""
    _, pcfg, _, params = _world("qwen3-8b")
    step = make_decode_step(pcfg, temperature=0.7, top_k=5)
    cache = T.init_cache(pcfg, 2, 4, CPU)
    tok = torch.tensor([3, 9], dtype=torch.int32)

    def draws(seed):
        gen = torch.Generator(CPU).manual_seed(seed)
        out = [step(params, cache, tok, gen) for _ in range(48)]
        return torch.stack([o[0] for o in out]), out[0][1]

    got, logits = draws(7)
    top = torch.topk(logits, 5, dim=-1).indices
    for row in range(2):
        assert set(got[:, row].tolist()) <= set(top[row].tolist())
        assert len(set(got[:, row].tolist())) > 1
    assert torch.equal(draws(7)[0], got)
    assert not torch.equal(draws(8)[0], got)


def test_init_params_shapes_dtypes_and_scales():
    """The torch-seeded init has the reference's tree, shapes and dtypes
    (f32 and bf16 params), and each weight's std within 5% of
    ``d_in ** -0.5`` (the embed's of 0.02); norms ones, biases zeros."""
    for dtype in ("float32", "bfloat16"):
        rcfg = dataclasses.replace(RR.reduced_config("qwen3-8b"),
                                   use_bias=True, param_dtype=dtype)
        pcfg = dataclasses.replace(PR.reduced_config("qwen3-8b"),
                                   use_bias=True, param_dtype=dtype)
        want = jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0),
                                                     rcfg))
        got = build_model(pcfg).init_params(0, pcfg, CPU)
        flat_want = {jax.tree_util.keystr(p): a for p, a in
                     jax.tree_util.tree_flatten_with_path(want)[0]}
        flat_got = {jax.tree_util.keystr(p): a for p, a in
                    jax.tree_util.tree_flatten_with_path(got)[0]}
        assert flat_got.keys() == flat_want.keys()
        for name, a in flat_want.items():
            assert tuple(flat_got[name].shape) == a.shape, name
            assert str(flat_got[name].dtype) == f"torch.{a.dtype.name}", name
    blocks = got["blocks"]
    d, ff = pcfg.d_model, pcfg.d_ff
    for name, d_in in (("wq", d), ("wk", d), ("wv", d), ("gate", d),
                       ("up", d), ("down", ff),
                       ("wo", pcfg.n_heads * pcfg.head_dim_)):
        std = float(blocks[name].float().std())
        assert abs(std / d_in ** -0.5 - 1) < 0.05, (name, std)
    assert abs(float(got["lm_head"].float().std()) / d ** -0.5 - 1) < 0.05
    assert abs(float(got["embed"].float().std()) / 0.02 - 1) < 0.05
    for name in ("attn_norm", "ffn_norm", "q_norm", "k_norm"):
        assert bool((blocks[name] == 1).all()), name
    for name in ("bq", "bk", "bv", "bo"):
        assert bool((blocks[name] == 0).all()), name
    assert bool((got["final_norm"] == 1).all())


@pytest.mark.parametrize("arch", sorted(RR.ARCHS))
def test_build_model_for_every_family(arch):
    """``build_model`` and ``init_params`` at ``reduced_config`` on the
    CPU for all ten architectures (every family); the tree, shapes and
    dtypes are the reference's, on ``meta`` too, and one decode step gives
    finite logits [B, Vp]."""
    cfg = PR.reduced_config(arch)
    api = build_model(cfg)
    rcfg = RR.reduced_config(arch)
    want = jax.eval_shape(lambda: ref_build(rcfg).init_params(
        jax.random.PRNGKey(0), rcfg))
    flat_want = {jax.tree_util.keystr(p): a for p, a in
                 jax.tree_util.tree_flatten_with_path(want)[0]}
    for dev in ("cpu", "meta"):
        got = api.init_params(0, cfg, dev)
        flat_got = {jax.tree_util.keystr(p): a for p, a in
                    jax.tree_util.tree_flatten_with_path(got)[0]}
        assert flat_got.keys() == flat_want.keys()
        for name, a in flat_want.items():
            assert tuple(flat_got[name].shape) == a.shape, name
            assert str(flat_got[name].dtype) == f"torch.{a.dtype.name}", name
            assert flat_got[name].device.type == dev, name
    params = api.init_params(0, cfg, CPU)
    cache = api.init_cache(cfg, 2, 4, CPU)
    if cfg.family == "encdec":
        cache = encdec.encode_prefill(
            params, cfg, torch.zeros((2, cfg.n_frames, cfg.d_model)), cache)
    logits, cache = api.decode_step(
        params, cfg, {"tokens": torch.tensor([1, 2], dtype=torch.int32)},
        cache)
    assert logits.shape == (2, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
    assert cache["len"].tolist() == [1, 1]


@pytest.mark.parametrize("arch", sorted(RR.ARCHS))
def test_lm_params_for_every_family(arch):
    """``convert.lm_params`` walks every family's tree at any depth: with
    bf16 params, each leaf has the reference's shape and dtype (the
    router, the gate weights and biases of the scans and the norms stay
    f32) and its values exactly; a wrong shape or key raises."""
    rcfg = dataclasses.replace(RR.reduced_config(arch),
                               param_dtype="bfloat16")
    pcfg = dataclasses.replace(PR.reduced_config(arch),
                               param_dtype="bfloat16")
    ref = ref_build(rcfg).init_params(jax.random.PRNGKey(1), rcfg)
    arrays = jax.tree.map(np.asarray, ref)
    got = convert.lm_params(arrays, pcfg, CPU)
    flat_ref = {jax.tree_util.keystr(p): a for p, a in
                jax.tree_util.tree_flatten_with_path(arrays)[0]}
    flat_got = {jax.tree_util.keystr(p): a for p, a in
                jax.tree_util.tree_flatten_with_path(got)[0]}
    assert flat_got.keys() == flat_ref.keys()
    for name, a in flat_ref.items():
        assert tuple(flat_got[name].shape) == a.shape, name
        assert str(flat_got[name].dtype) == f"torch.{a.dtype.name}", name
        np.testing.assert_array_equal(flat_got[name].float().numpy(),
                                      np.asarray(a, np.float32))
    bad = dict(arrays, lm_head=arrays["lm_head"][:, :-1])
    with pytest.raises(ValueError, match="lm_head"):
        convert.lm_params(bad, pcfg, CPU)
    with pytest.raises(ValueError, match="keys"):
        convert.lm_params(dict(arrays, extra=arrays["lm_head"]), pcfg, CPU)
