"""The port's training substrate against the reference's: ``utils/tree``,
``train/optimizer`` (AdamW, the schedule, clipping), the CE losses, the
int8 gradient compression, ``data/tokens``, ``train/checkpoint`` in both
directions between the packages, the training CLI with ``--resume``, and
one bf16 train step with bf16 moments against the reference's bf16 run,
and the compressed data-parallel step (int8 codes with error feedback)
at 1 shard in process and at 2 against one module-scoped subprocess of
the reference with two forced host devices. Inputs are drawn with numpy
from a seed; the reference's params and state come across with
``convert``. About 45 s on one core.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import BF16, by_path, rel_gap, train_batch, world
from repro.data import tokens as RD
from repro.launch.mesh import make_test_mesh as ref_mesh
from repro.train import checkpoint as RC
from repro.train import optimizer as RO
from repro.train import train_step as RT
from repro.utils import tree as RU
from repro_torch import convert
from repro_torch.data.tokens import MarkovTokens, TokenDataConfig
from repro_torch.launch import train as cli
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.train import checkpoint as C
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, clip_by_global_norm,
                                         step_scalars, update_leaf,
                                         warmup_cosine)
from repro_torch.train.train_step import (accumulate_grads, ce_loss,
                                          chunked_ce_loss, dequantize_int8,
                                          init_ef_state, make_loss_fn,
                                          make_compressed_dp_train_step,
                                          make_train_step, quantize_int8,
                                          split_batch)
from repro_torch.utils import tree as U

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
DP_TOL = 1e-4
DP_OPT = dict(lr=1e-4, weight_decay=0.01)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _arrays(seed=0, scale=1.0) -> dict:
    """A params-like tree with a stacked [L, ...] leaf, as numpy f32."""
    rng = np.random.default_rng(seed)
    return {"blocks": {"w": rng.normal(size=(3, 8, 16)) * scale,
                       "norm": rng.normal(size=(3, 16)) * scale},
            "head": rng.normal(size=(16, 10)) * scale,
            "bias": rng.normal(size=(10,)) * scale}


def _j(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _t(tree, dtype=torch.float32):
    return U.tree_map(lambda a: torch.as_tensor(np.asarray(a, np.float32)
                                                ).to(dtype), tree)


def _np(tree) -> dict:
    """A tree of either package as {path: f32 numpy}."""
    if isinstance(next(iter(U.leaves(tree))), torch.Tensor):
        return {k: v.float().numpy() for k, v in U.leaves_with_paths(tree)}
    return {k: np.asarray(v, np.float32) for k, v in
            U.leaves_with_paths(jax.tree.map(np.asarray, tree))}


def _bits(a) -> np.ndarray:
    """bf16 values (a tensor or an ml_dtypes array) as ordered ints, so
    that neighbours differ by 1."""
    if isinstance(a, torch.Tensor):
        raw = a.contiguous().view(torch.int16).numpy().view(np.uint16)
    else:
        raw = np.asarray(a).view(np.uint16)
    raw = raw.astype(np.int32)
    return np.where(raw & 0x8000, -(raw & 0x7FFF), raw)


# ------------------------------------------------------------------ tree

def test_tree_helpers_match_the_reference(monkeypatch):
    arrays = _arrays()
    ref = {**_j(arrays), "emb": jnp.ones((4, 8), jnp.bfloat16),
           "step": jnp.int32(3)}
    port = {**_t(arrays), "emb": torch.ones((4, 8), dtype=torch.bfloat16),
            "step": torch.tensor(3, dtype=torch.int32)}
    assert [k for k, _ in U.leaves_with_paths(port)] == [
        k for k, _ in U.leaves_with_paths(jax.tree.map(np.asarray, ref))]
    assert U.tree_param_count(port) == RU.tree_param_count(ref)
    assert U.tree_size_bytes(port) == RU.tree_size_bytes(ref)
    cast = U.tree_cast(port, torch.bfloat16)
    assert cast["step"].dtype == torch.int32
    for k, v in U.leaves_with_paths(RU.tree_cast(ref, jnp.bfloat16)):
        got = dict(U.leaves_with_paths(cast))[k]
        if v.dtype == jnp.bfloat16:
            np.testing.assert_array_equal(_bits(got), _bits(v))
    zeros = U.tree_zeros_like(port, torch.float16)
    assert all(z.dtype == torch.float16 and not z.any()
               for z in U.leaves(zeros))
    want = float(RU.global_norm(ref))
    assert float(U.global_norm(port)) == pytest.approx(want, rel=1e-6)
    monkeypatch.setattr(U, "SLICE", 7)     # every leaf in several slices
    assert len(U.flat_slices(port["blocks"]["w"])) == 55
    assert float(U.global_norm(port)) == pytest.approx(want, rel=1e-6)


# ------------------------------------------------------------- optimizer

def test_warmup_cosine_matches_the_reference():
    ref = RO.warmup_cosine(3e-4, warmup=20, total=100)
    port = warmup_cosine(3e-4, warmup=20, total=100)
    for step in range(121):
        got = port(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(ref(step)), rel=1e-6)


# AdamW settings of both packages: the reference's and the port's
ADAMW_CASES = {
    "plain": lambda sched: dict(lr=1e-2, clip_norm=None),
    "decay": lambda sched: dict(lr=1e-2, weight_decay=0.1, clip_norm=None),
    "decay-clip-schedule": lambda sched: dict(
        lr=sched(1e-2, warmup=2, total=5), weight_decay=0.1, clip_norm=1.0),
}


def _run_adamw(case, dtype="float32", steps=5):
    """``steps`` AdamW updates of both packages on the same params and
    random grads (large enough that a clip binds): (reference's params and
    state, port's)."""
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ropt = RO.AdamWConfig(**ADAMW_CASES[case](RO.warmup_cosine),
                          moment_dtype=jd)
    popt = AdamWConfig(**ADAMW_CASES[case](warmup_cosine),
                       moment_dtype=dtype)
    rp, pp = _j(_arrays(), jd), _t(_arrays(), td)
    rs, ps = RO.adamw_init(rp, ropt), adamw_init(pp, popt)
    for i in range(steps):
        g = _arrays(seed=10 + i, scale=5.0)
        rp, rs, rm = RO.adamw_update(_j(g, jd), rs, rp, ropt)
        pp, ps, pm = adamw_update(_t(g, td), ps, pp, popt)
        assert rm.keys() == pm.keys()
        for k in rm:
            assert float(pm[k]) == pytest.approx(float(rm[k]), rel=1e-6)
        if popt.clip_norm is not None:
            assert float(pm["grad_norm"]) > popt.clip_norm
    assert int(ps["step"]) == int(rs["step"]) == steps
    return (rp, rs), (pp, ps)


@pytest.mark.parametrize("case", sorted(ADAMW_CASES))
def test_adamw_f32_matches_the_reference(case):
    """f32 params and moments, 5 steps on a tree with a stacked [L, ...]
    leaf: within 1e-6 relative (of each leaf's largest value)."""
    (rp, rs), (pp, ps) = _run_adamw(case)
    for want, got in ((rp, pp), (rs["m"], ps["m"]), (rs["v"], ps["v"])):
        want, got = _np(want), _np(got)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-6 * np.abs(want[k]).max())


def test_adamw_bf16_moments_match_the_reference():
    """bf16 params and moments: every value at most one bf16 step from
    the reference's, at least 99.9% equal."""
    (rp, rs), (pp, ps) = _run_adamw("decay-clip-schedule", "bfloat16")
    n_equal = n_all = 0
    for want, got in ((rp, pp), (rs["m"], ps["m"]), (rs["v"], ps["v"])):
        assert all(t.dtype == torch.bfloat16 for t in U.leaves(got))
        for (_, w), g in zip(U.leaves_with_paths(
                jax.tree.map(np.asarray, want)), U.leaves(got)):
            steps = np.abs(_bits(g) - _bits(w))
            assert steps.max() <= 1
            n_equal += int((steps == 0).sum())
            n_all += steps.size
    assert n_equal / n_all >= 0.999, n_equal / n_all


def test_adamw_quadratic_matches_the_reference():
    """``tests/test_train.py``'s quadratic, 200 steps, in both packages."""
    target = np.asarray([1.5, -2.0, 0.5], np.float32)
    rp, pp = {"w": jnp.zeros(3)}, {"w": torch.zeros(3)}
    ropt, popt = RO.AdamWConfig(lr=0.1, clip_norm=None), AdamWConfig(
        lr=0.1, clip_norm=None)
    rs, ps = RO.adamw_init(rp, ropt), adamw_init(pp, popt)
    for _ in range(200):
        g = jax.grad(lambda p: jnp.sum((p["w"] - target) ** 2))(rp)
        rp, rs, _ = RO.adamw_update(g, rs, rp, ropt)
        w = pp["w"].clone().requires_grad_(True)
        torch.sum((w - torch.as_tensor(target)) ** 2).backward()
        pp, ps, _ = adamw_update({"w": w.grad}, ps, pp, popt)
    assert float(torch.sum((pp["w"] - torch.as_tensor(target)) ** 2)) < 1e-3
    np.testing.assert_allclose(pp["w"].numpy(), np.asarray(rp["w"]),
                               rtol=1e-6, atol=1e-6)


def test_clip_by_global_norm():
    g = {"a": torch.ones(4) * 10.0}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(
        1.0, rel=1e-5)
    assert clipped["a"] is g["a"]                  # scaled in place


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sliced_update_is_the_whole_leaf_formula(monkeypatch, dtype):
    """``adamw_update`` over slices of 7 elements equals ``update_leaf``
    on each whole leaf, bit for bit (f32 moments and params in ``dtype``;
    bf16 moments)."""
    for moments in ("float32", "bfloat16"):
        cfg = AdamWConfig(lr=1e-2, weight_decay=0.1, clip_norm=None,
                          moment_dtype=moments)
        params, grads = _t(_arrays(), dtype), _t(_arrays(seed=5), dtype)
        state = adamw_init(params, cfg)
        for t in U.leaves(state["m"]) + U.leaves(state["v"]):
            t.copy_(torch.rand(t.shape))
        whole = U.tree_map(torch.clone, {"p": params, "m": state["m"],
                                         "v": state["v"]})
        k = step_scalars(state["step"] + 1, cfg)
        for p, g, m, v in zip(U.leaves(whole["p"]), U.leaves(grads),
                              U.leaves(whole["m"]), U.leaves(whole["v"])):
            update_leaf(p, g, m, v, k, cfg.weight_decay, cfg.eps)
        monkeypatch.setattr(U, "SLICE", 7)
        params, state, _ = adamw_update(grads, state, params, cfg)
        for a, b in zip(U.leaves({"p": params, "m": state["m"],
                                  "v": state["v"]}), U.leaves(whole)):
            assert torch.equal(a.view(torch.int16 if a.element_size() == 2
                                      else torch.int32),
                               b.view(torch.int16 if b.element_size() == 2
                                      else torch.int32))
        monkeypatch.undo()


# -------------------------------------------------------------------- CE

def test_ce_losses_match_the_reference():
    """``ce_loss`` and ``chunked_ce_loss`` (chunks 8, 16, 32 and 5, the
    fallback to one chunk) with a padded vocab tail: values and grads."""
    rng = np.random.default_rng(0)
    b, s, d, v = 2, 32, 8, 50
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    w = rng.normal(size=(d, v)).astype(np.float32)
    labels = rng.integers(0, v - 10, (b, s)).astype(np.int32)
    jx, jw, jl = jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels)
    tx, tw, tl = torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(
        labels)
    want = RT.ce_loss(jnp.einsum("bsd,dv->bsv", jx, jw), jl, v - 10)
    got = ce_loss(torch.einsum("bsd,dv->bsv", tx, tw), tl, v - 10)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    for chunk in (8, 16, 32, 5):
        want_fn = lambda xx, ww: RT.chunked_ce_loss(xx, ww, jl, v - 10,
                                                    chunk=chunk)
        want, (gx, gw) = jax.value_and_grad(want_fn, argnums=(0, 1))(jx, jw)
        xx, ww = tx.clone().requires_grad_(True), tw.clone().requires_grad_(
            True)
        got = chunked_ce_loss(xx, ww, tl, v - 10, chunk=chunk)
        got.backward()
        assert float(got) == pytest.approx(float(want), rel=1e-5)
        np.testing.assert_allclose(xx.grad.numpy(), gx, rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(ww.grad.numpy(), gw, rtol=1e-4,
                                   atol=1e-6)
    assert not ww.grad[:, v - 10:].any()           # the padded tail


# ------------------------------------------------------------------ int8

def test_int8_codes_match_the_reference():
    """Codes, scale and dequantized values bit for bit, with exact halves
    (rounded to even) and random values."""
    rng = np.random.default_rng(1)
    ties = np.asarray([127, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -127, 0],
                      np.float32)
    for g in (ties, rng.normal(size=(4, 64)).astype(np.float32)):
        rq, rs = RT.quantize_int8(jnp.asarray(g))
        q, s = quantize_int8(torch.as_tensor(g))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert s.numpy().tobytes() == np.asarray(rs).tobytes()
        assert dequantize_int8(q, s).numpy().tobytes() == np.asarray(
            RT.dequantize_int8(rq, rs)).tobytes()
    assert quantize_int8(torch.as_tensor(ties))[0].tolist() == [
        127, 0, 2, 2, 0, -2, 126, -127, 0]


def test_int8_error_feedback():
    """``tests/test_train.py``'s error-feedback test on the port: the
    accumulated error goes to zero."""
    g = torch.as_tensor(np.random.default_rng(1).normal(size=(256,)),
                        dtype=torch.float32)
    q, scale = quantize_int8(g)
    assert float(torch.linalg.norm(dequantize_int8(q, scale) - g)
                 / torch.linalg.norm(g)) < 0.01
    ef, applied = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(50):
        q, scale = quantize_int8(g + ef)
        deq = dequantize_int8(q, scale)
        ef = (g + ef) - deq
        applied += deq
    np.testing.assert_allclose((applied / 50).numpy(), g.numpy(), rtol=0.01,
                               atol=1e-3)


# ---------------------------------------------------------------- tokens

def test_markov_tokens_match_the_reference():
    cfg = dict(vocab_size=512, seq_len=16, batch_size=4, seed=3)
    ref = RD.MarkovTokens(RD.TokenDataConfig(**cfg))
    port = MarkovTokens(TokenDataConfig(**cfg))
    np.testing.assert_array_equal(port.successors, ref.successors)
    for want, got in zip(ref.batches(3), port.batches(3)):
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------------------ checkpoint

def _ckpt_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.normal(size=(2, 3)).astype(np.float32),
                       "emb": rng.normal(size=(5, 4)).astype(np.float32)},
            "opt": {"step": np.int32(7),
                    "m": {"w": rng.normal(size=(2, 3)).astype(np.float32)}}}


def test_port_reads_a_reference_checkpoint_with_bf16_leaves(tmp_path):
    """The reference writes bf16 leaves as |V2 records (and cannot read
    them back itself); the port reads every leaf bit for bit."""
    arrays = _ckpt_tree()
    ref = {"params": {"w": jnp.asarray(arrays["params"]["w"]),
                      "emb": jnp.asarray(arrays["params"]["emb"],
                                         jnp.bfloat16)},
           "opt": {"step": jnp.int32(7),
                   "m": {"w": jnp.asarray(arrays["opt"]["m"]["w"],
                                          jnp.bfloat16)}}}
    RC.save(str(tmp_path), 7, ref)
    with np.load(tmp_path / "step_00000007" / "shard_0.npz") as z:
        assert z["params/emb"].dtype == np.dtype("V2")
    with pytest.raises(ValueError, match="cast"):      # the reference's fault
        RC.restore(str(tmp_path), 7, ref)
    like = {"params": {"w": torch.zeros(2, 3),
                       "emb": torch.zeros(5, 4, dtype=torch.bfloat16)},
            "opt": {"step": torch.tensor(0, dtype=torch.int32),
                    "m": {"w": torch.zeros(2, 3, dtype=torch.bfloat16)}}}
    assert C.latest_step(str(tmp_path)) == 7
    back = C.restore(str(tmp_path), 7, like)
    assert back["params"]["w"].numpy().tobytes() == np.asarray(
        ref["params"]["w"]).tobytes()
    for got, want in ((back["params"]["emb"], ref["params"]["emb"]),
                      (back["opt"]["m"]["w"], ref["opt"]["m"]["w"])):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert back["opt"]["step"].dtype == torch.int32
    assert int(back["opt"]["step"]) == 7


def test_reference_reads_a_port_checkpoint(tmp_path):
    """The port's f32 and int leaves through the reference's ``restore``;
    the manifests of the two packages are the same; a bf16 leaf is stored
    with the reference's bytes."""
    arrays = _ckpt_tree()
    port = U.tree_map(torch.as_tensor, arrays)
    C.save(str(tmp_path / "port"), 3, port)
    RC.save(str(tmp_path / "ref"), 3, jax.tree.map(jnp.asarray, arrays))
    manifests = [json.load(open(tmp_path / d / "step_00000003" /
                                "manifest.json")) for d in ("port", "ref")]
    assert manifests[0] == manifests[1]
    back = RC.restore(str(tmp_path / "port"), 3,
                      jax.tree.map(jnp.zeros_like, arrays))
    for k, v in U.leaves_with_paths(jax.tree.map(np.asarray, back)):
        want = dict(U.leaves_with_paths(arrays))[k]
        assert v.dtype == want.dtype
        np.testing.assert_array_equal(v, want)
    bf = {"x": torch.as_tensor(arrays["params"]["emb"]).to(torch.bfloat16)}
    C.save(str(tmp_path / "bf"), 1, bf)
    RC.save(str(tmp_path / "rbf"), 1, {"x": jnp.asarray(
        arrays["params"]["emb"], jnp.bfloat16)})
    with np.load(tmp_path / "bf" / "step_00000001" / "shard_0.npz") as a, \
            np.load(tmp_path / "rbf" / "step_00000001" / "shard_0.npz") as b:
        assert a["x"].dtype == b["x"].dtype == np.dtype("V2")
        assert a["x"].tobytes() == b["x"].tobytes()
    back = C.restore(str(tmp_path / "bf"), 1, bf)
    assert torch.equal(back["x"].view(torch.int16), bf["x"].view(torch.int16))


def test_checkpoint_commit_marker_async_and_devices(tmp_path):
    """A step directory without ``COMMITTED`` is ignored; the async save
    snapshots the leaves before it returns; ``restore`` places leaves on
    one device or on a tree of devices (``launch/mesh.py``'s)."""
    tree = {"w": torch.ones(3)}
    d = C.save(str(tmp_path / "a"), 3, tree)
    os.remove(os.path.join(d, "COMMITTED"))
    assert C.latest_step(str(tmp_path / "a")) is None
    assert C.latest_step(str(tmp_path / "none")) is None
    tree = {"w": torch.full((128,), 3.0), "step": torch.tensor(
        11, dtype=torch.int32)}
    saver = C.AsyncCheckpointer()
    saver.save(str(tmp_path / "b"), 11, tree)
    tree["w"].fill_(-1.0)                          # after the snapshot
    saver.wait()
    like = U.tree_zeros_like(tree)
    back = C.restore(str(tmp_path / "b"), 11, like)
    assert torch.equal(back["w"], torch.full((128,), 3.0))
    mesh = make_test_mesh((2,), ("data",), CPU)
    back = C.restore(str(tmp_path / "b"), 11, like, devices=mesh.devices[1])
    assert all(t.device == mesh.devices[1] for t in U.leaves(back))
    back = C.restore(str(tmp_path / "b"), 11, like,
                     devices={"w": mesh.devices[0], "step": "cpu"})
    assert int(back["step"]) == 11
    with pytest.raises(ValueError, match="shape mismatch"):
        C.restore(str(tmp_path / "b"), 11, {"w": torch.zeros(4),
                                            "step": like["step"]})


# ------------------------------------------------------------------- CLI

def _cli(*args):
    return cli.run(cli.parse_args(["--reduced", "--batch", "2", "--seq",
                                   "16", "--device", "cpu", *args]))


def test_cli_resume_is_bitwise(tmp_path):
    """4 straight steps equal 2 steps, ``--resume``, then 2 more: the
    metrics of steps 3 and 4 and every leaf of the step-4 checkpoint, bit
    for bit."""
    arch = ["--arch", "qwen3-8b", "--ckpt-every", "2"]
    straight = _cli(*arch, "--steps", "4", "--ckpt", str(tmp_path / "a"))
    assert [m["step"] for m in straight] == [1, 2, 3, 4]
    assert all(np.isfinite(m["loss"]) for m in straight)
    first = _cli(*arch, "--steps", "2", "--ckpt", str(tmp_path / "b"))
    assert first == straight[:2]
    resumed = _cli(*arch, "--steps", "4", "--ckpt", str(tmp_path / "b"),
                   "--resume")
    assert resumed == straight[2:]
    with np.load(tmp_path / "a" / "step_00000004" / "shard_0.npz") as a, \
            np.load(tmp_path / "b" / "step_00000004" / "shard_0.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k


def test_cli_vlm_and_encdec():
    """The vlm family runs with the reference's stub extras; encdec is
    refused with the reference's message."""
    out = _cli("--arch", "qwen2-vl-7b", "--steps", "1")
    assert np.isfinite(out[0]["loss"])
    with pytest.raises(SystemExit, match="decoder-only"):
        _cli("--arch", "whisper-tiny", "--steps", "1")


# ------------------------------------------------------------------ bf16

# One bf16 train step with bf16 moments (reduced qwen3-8b, 4 x 16 tokens,
# lr 1e-3) against the reference's bf16 step, as drawn and with the FFN
# gate zeroed (``tests/test_torch_models.py::BF16_MODEL_BOUNDS``' split:
# XLA's CPU backend rounds bf16 ``silu`` after each of its ops, ``F.silu``
# once): the loss's relative gap, the relative L2 of the first moment (the
# clipped gradient, bf16), the share of new bf16 params that differ and
# their largest difference (one bf16 step of a value in [0.5, 1) is
# 3.9e-3). Measured at these seeds: drawn 1.50e-4, 1.35e-2, 3.76e-3,
# 3.91e-3; gate zeroed 7.4e-6, 6.23e-3, 9.3e-4, 2.20e-3. The bounds are
# about 1.5 times those, and one bf16 step of [0.5, 1) for the params.
BF16_TRAIN_BOUNDS = {
    "drawn": dict(loss=2.5e-4, moment=2e-2, params_off=6e-3,
                  params_max=3.91e-3),
    "gate_zeroed": dict(loss=1.2e-5, moment=1e-2, params_off=1.5e-3,
                        params_max=3.91e-3),
}


@pytest.mark.parametrize("weights", sorted(BF16_TRAIN_BOUNDS))
def test_bf16_train_step_against_the_reference(weights):
    rcfg, pcfg, ref, params = world("qwen3-8b", **BF16)
    if weights == "gate_zeroed":
        ref = {**ref, "blocks": {**ref["blocks"], "gate": jnp.zeros_like(
            ref["blocks"]["gate"])}}
        params["blocks"]["gate"].zero_()
    ropt = RO.AdamWConfig(lr=1e-3, moment_dtype=jnp.bfloat16)
    popt = AdamWConfig(lr=1e-3, moment_dtype="bfloat16")
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, pcfg.vocab_size, (4, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    rnew, rstate, rm = jax.jit(RT.make_train_step(rcfg, ropt))(
        ref, RO.adamw_init(ref, ropt), {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    pnew, pstate, pm = make_train_step(pcfg, popt)(
        params, adamw_init(params, popt),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    assert pstate["m"]["embed"].dtype == torch.bfloat16
    flat = lambda d: np.concatenate([v.ravel() for v in d.values()])
    pairs = [(g.float().numpy().ravel(), np.asarray(w, np.float32).ravel())
             for g, w in zip(U.leaves(pnew), jax.tree.leaves(rnew))
             if g.dtype == torch.bfloat16]
    diff = np.concatenate([np.abs(g - w) for g, w in pairs])
    gaps = {"loss": abs(float(pm["loss"]) - float(rm["loss"]))
            / float(rm["loss"]),
            "moment": float(np.linalg.norm(flat(_np(pstate["m"]))
                                           - flat(_np(rstate["m"])))
                            / np.linalg.norm(flat(_np(rstate["m"])))),
            "params_off": float(np.mean(diff > 0)),
            "params_max": float(diff.max())}
    for k, bound in BF16_TRAIN_BOUNDS[weights].items():
        assert gaps[k] <= bound, (k, gaps[k], bound)


# ------------------------------------------------------ compressed DP

def _check_dp(params, ref_params, ef, ref_ef):
    """The compressed step's outputs against the reference's: each
    residual buffer within ``DP_TOL`` at 99.9% of entries and everywhere
    within one code step of its leaf (a code one apart moves the residual
    by the scale, twice the largest residual); each param leaf within
    ``DP_TOL`` relative L2 (a code one apart changes that entry's averaged
    gradient by a scale / n, which AdamW can turn into a step of up to
    the lr)."""
    n_close = n_all = 0
    for k, want in ref_ef.items():
        gap = np.abs(ef[k] - want)
        assert gap.max() <= 2.02 * np.abs(want).max() + DP_TOL, k
        n_close += int((gap <= DP_TOL).sum())
        n_all += gap.size
    assert n_close / n_all >= 0.999, n_close / n_all
    for k, want in ref_params.items():
        assert rel_gap(params[k], want) <= DP_TOL, k


def test_compressed_dp_one_shard():
    """The int8 error-feedback step at 1 shard, 3 steps, in process
    against the reference's on a 1-device mesh (its state carried across
    with ``convert``)."""
    rcfg, pcfg, ref, params = world("qwen3-8b")
    ropt, popt = RO.AdamWConfig(**DP_OPT), AdamWConfig(**DP_OPT)
    rstate = RT.init_ef_state(ref, RO.adamw_init(ref, ropt))
    pstate = convert.adamw_state(jax.tree.map(np.asarray, rstate), pcfg,
                                 popt, CPU)
    assert all(v.shape[0] == 1 for v in by_path(pstate["ef"]).values())
    rstep = jax.jit(RT.make_compressed_dp_train_step(
        rcfg, ropt, ref_mesh((1,), ("data",))))
    pstep = make_compressed_dp_train_step(
        pcfg, popt, make_test_mesh((1,), ("data",), CPU))
    for i in range(3):
        batch = train_batch(pcfg, 4, 16, seed=i)
        ref, rstate, rm = rstep(ref, rstate, {k: jnp.asarray(v)
                                              for k, v in batch.items()})
        params, pstate, pm = pstep(params, pstate, {
            k: torch.as_tensor(v) for k, v in batch.items()})
        for k in rm:
            assert float(pm[k]) == pytest.approx(float(rm[k]), rel=DP_TOL,
                                                 abs=DP_TOL), (i, k)
    ef = by_path(pstate["ef"])
    assert all(v.shape[0] == 1 for v in ef.values())
    _check_dp(by_path(params), by_path(ref),
              {k: v[0] for k, v in ef.items()}, by_path(rstate["ef"]))


# the reference's compressed step at 2 shards (two forced host devices):
# step-1 int8 codes per shard, each device's residual after step 1, the
# metrics of 3 steps and the params after them
_REFERENCE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.registry import reduced_config
from repro.launch.mesh import make_test_mesh
from repro.models.model import build_model
from repro.train import optimizer as RO
from repro.train import train_step as RT
OPT, batches = json.loads(sys.argv[2]), json.loads(sys.argv[3])
rcfg = reduced_config("qwen3-8b")
ref = build_model(rcfg).init_params(jax.random.PRNGKey(2), rcfg)
ropt = RO.AdamWConfig(**OPT)
state = RT.init_ef_state(ref, RO.adamw_init(ref, ropt))
step = jax.jit(RT.make_compressed_dp_train_step(
    rcfg, ropt, make_test_mesh((2,), ("data",))))
loss = RT.make_loss_fn(rcfg)
grad = jax.jit(jax.grad(lambda p, b: loss(p, b)[0]))
out, metrics = {}, []
key = lambda path: "/".join(str(p.key) for p in path)
b0 = {k: np.asarray(v, np.int32) for k, v in batches[0].items()}
for i in range(2):
    half = {k: jnp.asarray(v[2 * i:2 * i + 2]) for k, v in b0.items()}
    for path, g in jax.tree_util.tree_flatten_with_path(grad(ref, half))[0]:
        out[f"q{i}/{key(path)}"] = np.asarray(RT.quantize_int8(
            g.astype(jnp.float32))[0])
for i, b in enumerate(batches):
    ref, state, m = step(ref, state, {k: jnp.asarray(np.asarray(v, np.int32))
                                      for k, v in b.items()})
    metrics.append({k: float(v) for k, v in m.items()})
    if i == 0:
        for path, e in jax.tree_util.tree_flatten_with_path(state["ef"])[0]:
            shards = sorted(e.addressable_shards, key=lambda s: s.device.id)
            out["ef/" + key(path)] = np.stack([np.asarray(s.data)
                                               for s in shards])
for path, p in jax.tree_util.tree_flatten_with_path(ref)[0]:
    out["p/" + key(path)] = np.asarray(p)
np.savez(sys.argv[1], **out)
print(json.dumps(metrics))
"""


@pytest.fixture(scope="module")
def reference_dp(tmp_path_factory):
    """The reference's 2-shard run, once per module (its params drawn as
    ``world`` draws them)."""
    cfg = world("qwen3-8b")[1]
    batches = [{k: v.tolist() for k, v in
                train_batch(cfg, 4, 16, seed=i).items()} for i in range(3)]
    path = tmp_path_factory.mktemp("dp_ref") / "ref.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFERENCE, str(path),
                          json.dumps(DP_OPT), json.dumps(batches)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(path)), json.loads(out.stdout.strip().splitlines()[-1])


def test_compressed_dp_two_shards(reference_dp):
    """2 shards on one controller against the reference's 2 devices: the
    step-1 int8 codes of each shard (at least 99.9% equal, at most 1
    apart), each shard's residual after step 1 and the params after 3
    steps (``_check_dp``), the metrics of each step within ``DP_TOL``."""
    arrays, ref_metrics = reference_dp
    _, pcfg, _, params = world("qwen3-8b")
    popt = AdamWConfig(**DP_OPT)
    loss_fn = make_loss_fn(pcfg)
    batches = [train_batch(pcfg, 4, 16, seed=i) for i in range(3)]
    n_equal = n_all = 0
    first = {k: torch.as_tensor(v) for k, v in batches[0].items()}
    for i, half in enumerate(split_batch(first, 2)):
        grads, _ = accumulate_grads(loss_fn, params, [half])
        for key, g in U.leaves_with_paths(grads):
            q = quantize_int8(g.float())[0].numpy().astype(np.int32)
            want = arrays[f"q{i}/{key}"].astype(np.int32)
            assert np.abs(q - want).max() <= 1, key
            n_equal += int((q == want).sum())
            n_all += q.size
    assert n_equal / n_all >= 0.999, n_equal / n_all
    state = init_ef_state(params, adamw_init(params, popt))
    step = make_compressed_dp_train_step(
        pcfg, popt, make_test_mesh((2,), ("data",), CPU))
    for i, batch in enumerate(batches):
        params, state, m = step(params, state, {
            k: torch.as_tensor(v) for k, v in batch.items()})
        for k, want in ref_metrics[i].items():
            assert float(m[k]) == pytest.approx(want, rel=DP_TOL,
                                                abs=DP_TOL), (i, k)
        if i == 0:
            ef = by_path(state["ef"])
            assert all(v.shape[0] == 2 for v in ef.values())
    _check_dp(by_path(params), {k[2:]: v for k, v in arrays.items()
                                if k.startswith("p/")},
              ef, {k[3:]: v for k, v in arrays.items() if k.startswith("ef/")})
