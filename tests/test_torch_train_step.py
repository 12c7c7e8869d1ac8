"""The port's train step (``repro_torch/train/train_step.py``) against the
reference's, in f32 at each architecture's ``reduced_config``: the
reference's params and AdamW state carried across with ``convert``, the
same numpy batches, one step in each package (the reference jitted), in
one microbatch and in two, and an 80-token batch through the flash path
(``attn_chunk`` 64).

Loss, ``moe_aux``, ``grad_norm`` and ``lr`` agree within 1e-4, every
gradient leaf (the first moment after one step, (1 - b1) x the clipped
gradient) within 1e-4 relative L2, and the new params within 1e-4 at
``LR``. The first AdamW step moves a param by about lr x sign(g), so a
gradient that is zero up to f32 rounding can move it either way by up to
lr; at ``LR`` = 1e-4 that stays within the bound. The xLSTM is the
exception: its random-weight recurrence carries f32 rounding far
(``PERF.md`` §6), and its gradients and new params are held within
max(1e-4, 4 x the port's own gap between two summation orders of the same
step, the parallel and the chunkwise mLSTM), as ``chip_smoke.py`` phase 9
holds the full xLSTM's decode.

About 70 s on one core, most of it the reference compiling a step per
architecture (the reduced jamba 10-15 s a step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import by_path, max_gap, rel_gap, train_batch, world
from repro.train import optimizer as RO
from repro.train import train_step as RT
from repro_torch import convert
from repro_torch.configs.registry import ARCHS
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_step import make_train_step

CPU = torch.device("cpu")
LR = 1e-4
TOL = 1e-4
OPT = dict(lr=LR, weight_decay=0.01)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _outputs(new, state, metrics):
    return (by_path(new), {k: float(v) for k, v in metrics.items()},
            by_path(state["m"]))


def _port_step(arch, b, s, **overrides):
    """The port's step from the reference's params and zero state: (new
    params, metrics, new first moments: (1 - b1) x the clipped
    gradient)."""
    _, pcfg, _, params = world(arch, **overrides)
    popt = AdamWConfig(**OPT)
    new, state, m = make_train_step(pcfg, popt)(
        params, adamw_init(params, popt), _t(train_batch(pcfg, b, s)))
    assert int(state["step"]) == 1
    return _outputs(new, state, m)


def _step_both(arch, b, s, **overrides):
    """One step of each package from the same params, the reference's
    state carried across with ``convert``, the same batch: (reference's,
    port's) outputs as ``_port_step``'s."""
    rcfg, pcfg, ref, params = world(arch, **overrides)
    ropt, popt = RO.AdamWConfig(**OPT), AdamWConfig(**OPT)
    rstate = RO.adamw_init(ref, ropt)
    pstate = convert.adamw_state(jax.tree.map(np.asarray, rstate), pcfg,
                                 popt, CPU)
    batch = train_batch(pcfg, b, s)
    rout = jax.jit(RT.make_train_step(rcfg, ropt))(ref, rstate, _j(batch))
    pout = make_train_step(pcfg, popt)(params, pstate, _t(batch))
    return _outputs(*rout), _outputs(*pout)


def _floor(grads: dict) -> float:
    """1e-3 of the whole gradient's norm: the scale a leaf whose gradient
    is zero in exact arithmetic (a key bias's, under the softmax) is
    compared at."""
    return 1e-3 * float(np.sqrt(sum(np.sum(g * g) for g in grads.values())))


def _check(arch, ref_out, port_out, bounds=None):
    """Metrics within ``TOL``; each first-moment leaf (the clipped
    gradient) within its relative L2 bound (``_floor``); the new params
    within the params bound (max abs)."""
    (rnew, rm, rgrads), (pnew, pm, pgrads) = ref_out, port_out
    bounds = bounds or {}
    assert rm.keys() == pm.keys() == {"loss", "moe_aux", "grad_norm", "lr"}
    for k in rm:
        assert pm[k] == pytest.approx(rm[k], rel=TOL, abs=TOL), (arch, k)
    floor = _floor(rgrads)
    for k, g in rgrads.items():
        gap = rel_gap(pgrads[k], g, floor)
        assert gap <= bounds.get(k, TOL), (arch, k, gap)
    gap = max_gap(pnew, rnew)
    assert gap <= bounds.get("params", TOL), (arch, gap)


def _order_bounds(arch, b, s, **overrides) -> dict:
    """max(``TOL``, 4 x the port's own gap between two summation orders of
    the same step, the parallel and the chunkwise mLSTM), per first-moment
    leaf and for the new params, as ``chip_smoke.py`` phase 9 holds the
    full xLSTM's decode."""
    p0, _, m0 = _port_step(arch, b, s, **overrides)
    p1, _, m1 = _port_step(arch, b, s, mlstm_chunk=s // 2, **overrides)
    floor = _floor(m0)
    bounds = {k: max(TOL, 4 * rel_gap(m1[k], m0[k], floor)) for k in m0}
    bounds["params"] = max(TOL, 4 * max_gap(p1, p0))
    return bounds


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_step_matches_the_reference(arch, micro):
    """One ``make_train_step`` per architecture, 4 x 16 tokens, in one
    microbatch and in two."""
    ref_out, port_out = _step_both(arch, 4, 16, microbatches=micro)
    bounds = None
    if arch == "xlstm-1.3b":
        bounds = _order_bounds(arch, 4, 16, microbatches=micro)
    _check(arch, ref_out, port_out, bounds)


def test_train_step_through_flash():
    """80 tokens at ``attn_chunk`` 64: the flash path (its chunk body
    checkpointed) in two microbatches."""
    ref_out, port_out = _step_both("qwen3-8b", 4, 80, microbatches=2)
    _check("qwen3-8b", ref_out, port_out)
