"""Training on the card: one f32 train step at ``reduced_config`` on the
card against the same step on the CPU (reduced qwen3-8b within 1e-5, the
other families within 1e-4; the moe and hybrid families' gather backward
is a ``scatter_add`` with atomics on the card, so they hold a tolerance,
not bits), the sliced AdamW update bit for bit against the whole-leaf
formula (f32 and bf16 moments), ``launch/train.py --resume`` bit for bit,
and the compressed data-parallel step at 2 shards on the card against the
CPU. Run on the H100 with

    python -m pytest -q -m cuda tests/test_torch_train_cuda.py

Without a card every test here skips (the ``card`` fixture decides).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.launch import train as cli
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_model
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, step_scalars,
                                         update_leaf)
from repro_torch.train.train_step import (init_ef_state,
                                          make_compressed_dp_train_step,
                                          make_train_step)
from repro_torch.utils import tree as U

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")
LR = 1e-4
# card vs CPU, relative: metrics, each first-moment leaf (the clipped
# gradient; a leaf zero in exact arithmetic compared at 1e-3 of the whole
# gradient's norm) and the new params at 99.99% of entries. The first
# AdamW step moves a param by about lr x sign(g), so an entry whose
# gradient is zero up to rounding may move either way: every entry is
# held within 2 lr + the tolerance. The xLSTM's exponential gates carry
# f32 rounding far (``tests/test_torch_families_cuda.py``): 1e-3.
TOL = {"qwen3-8b": 1e-5, "xlstm-1.3b": 1e-3}
FAMILIES = ["qwen3-8b", "qwen2-moe-a2.7b", "qwen2-vl-7b", "xlstm-1.3b",
            "whisper-tiny", "jamba-1.5-large-398b"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _batch(cfg, dev, seed=0, b=4, s=32):
    rng = np.random.default_rng(seed)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                                dtype=torch.int32) for k in ("tokens",
                                                             "labels")}
    if cfg.family == "encdec":
        batch["frames"] = torch.as_tensor(rng.normal(
            size=(b, cfg.n_frames, cfg.d_model)), dtype=torch.float32)
    if cfg.family == "vlm":
        batch.update(cli.vlm_extras(cfg, batch, CPU))
    return {k: v.to(dev) for k, v in batch.items()}


def _cpu(tree) -> dict:
    return {k: v.detach().cpu().float().numpy()
            for k, v in U.leaves_with_paths(tree)}


def _step(cfg, dev, micro=1):
    cfg = dataclasses.replace(cfg, microbatches=micro)
    opt = AdamWConfig(lr=LR, weight_decay=0.01)
    params = build_model(cfg).init_params(0, cfg, CPU)
    params = U.tree_map(lambda t: t.to(dev), params)
    new, state, m = make_train_step(cfg, opt)(params, adamw_init(params, opt),
                                              _batch(cfg, dev))
    return _cpu(new), {k: float(v) for k, v in m.items()}, _cpu(state["m"])


def _close(got, want, tol):
    (gp, gm, gg), (wp, wm, wg) = got, want
    for k in wm:
        assert gm[k] == pytest.approx(wm[k], rel=tol, abs=tol), k
    floor = 1e-3 * np.sqrt(sum(np.sum(g * g) for g in wg.values()))
    for k, g in wg.items():
        gap = np.linalg.norm(gg[k] - g) / max(np.linalg.norm(g), floor)
        assert gap <= tol, (k, gap)
    n_close = n_all = 0
    for k, p in wp.items():
        diff = np.abs(gp[k] - p)
        assert diff.max() <= 2 * LR + tol, k
        n_close += int((diff <= tol * np.maximum(np.abs(p), 1)).sum())
        n_all += diff.size
    assert n_close / n_all >= 0.9999, n_close / n_all


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_card_equals_the_cpu(card, arch):
    """One f32 step from the same init and batch, in two microbatches for
    the dense model."""
    cfg = reduced_config(arch)
    micro = 2 if arch == "qwen3-8b" else 1
    _close(_step(cfg, card, micro), _step(cfg, CPU, micro),
           TOL.get(arch, 1e-4))


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_sliced_update_is_the_whole_leaf_formula(card, monkeypatch,
                                                 moments):
    """``adamw_update`` over slices of 2^20 elements equals ``update_leaf``
    on the whole [3, 1024, 1536] leaf, bit for bit, params in bf16."""
    gen = torch.Generator(card).manual_seed(3)
    shape = (3, 1024, 1536)
    draw = lambda dtype, s: (torch.randn(shape, generator=gen, device=card)
                             * s).to(dtype)
    md = torch.float32 if moments == "float32" else torch.bfloat16
    cfg = AdamWConfig(lr=1e-3, weight_decay=0.01, clip_norm=None,
                      moment_dtype=moments)
    p, g = draw(torch.bfloat16, 1.0), draw(torch.bfloat16, 1e-2)
    m, v = draw(md, 1e-2), draw(md, 1e-2).abs()
    state = {"step": torch.tensor(4, dtype=torch.int32, device=card),
             "m": {"w": m.clone()}, "v": {"w": v.clone()}}
    whole = [p.clone(), m, v]
    update_leaf(whole[0], g, whole[1], whole[2],
                step_scalars(state["step"] + 1, cfg), cfg.weight_decay,
                cfg.eps)
    monkeypatch.setattr(U, "SLICE", 1 << 20)
    assert len(U.flat_slices(p)) == 5
    params, state, _ = adamw_update({"w": g}, state, {"w": p}, cfg)
    for got, want in zip((params["w"], state["m"]["w"], state["v"]["w"]),
                         whole):
        bits = torch.int16 if got.element_size() == 2 else torch.int32
        assert torch.equal(got.view(bits), want.view(bits))


def test_cli_resume_is_bitwise(card, tmp_path):
    """``launch/train.py --reduced`` on the card: 4 straight steps equal 2,
    ``--resume``, 2 more (metrics and the step-4 checkpoint)."""
    args = ["--arch", "qwen3-8b", "--reduced", "--batch", "4", "--seq",
            "64", "--ckpt-every", "2", "--device", "cuda"]
    run = lambda *extra: cli.run(cli.parse_args([*args, *extra]))
    straight = run("--steps", "4", "--ckpt", str(tmp_path / "a"))
    assert run("--steps", "2", "--ckpt", str(tmp_path / "b")) == straight[:2]
    assert run("--steps", "4", "--ckpt", str(tmp_path / "b"),
               "--resume") == straight[2:]
    last = "step_00000004/shard_0.npz"
    with np.load(tmp_path / "a" / last) as a, \
            np.load(tmp_path / "b" / last) as b:
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k


def _dp(dev, steps=3):
    cfg = reduced_config("qwen3-8b")
    opt = AdamWConfig(lr=LR, weight_decay=0.01)
    params = U.tree_map(lambda t: t.to(dev), build_model(cfg).init_params(
        0, cfg, CPU))
    state = init_ef_state(params, adamw_init(params, opt))
    step = make_compressed_dp_train_step(
        cfg, opt, make_test_mesh((2,), ("data",), dev))
    metrics = []
    for i in range(steps):
        params, state, m = step(params, state, _batch(cfg, dev, seed=i))
        metrics.append({k: float(v) for k, v in m.items()})
    return _cpu(params), metrics, _cpu(state["ef"])


def test_compressed_dp_card_equals_the_cpu(card):
    """2 shards, 3 steps: metrics within 1e-4, each residual within 1e-4
    at 99.9% of entries (a code one apart moves an entry by the scale),
    each param leaf within 1e-4 relative L2."""
    (gp, gm, ge), (wp, wm, we) = _dp(card), _dp(CPU)
    for got, want in zip(gm, wm):
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-4), k
    n_close = n_all = 0
    for k, e in we.items():
        assert ge[k].shape[0] == 2
        n_close += int((np.abs(ge[k] - e) <= 1e-4).sum())
        n_all += e.size
    assert n_close / n_all >= 0.999
    for k, p in wp.items():
        assert np.linalg.norm(gp[k] - p) / np.linalg.norm(p) <= 1e-4, k
