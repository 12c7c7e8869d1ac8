"""The dry-run's architecture cells of the port against the reference, on
the CPU: ``launch/sharding.py``, ``utils/hlo.py``, the model specs and
``launch/dryrun.py``'s sizing.

The reference's ``repro/launch/dryrun.py`` sets ``XLA_FLAGS`` (512 host
devices) when it is imported, so it runs once, in a module-scoped
subprocess, as ``tests/test_torch_dryrun.py`` runs its own. There:

* ``param_specs``, ``opt_specs``, ``batch_specs`` and ``cache_specs_tree``
  for all ten archs at their published configs, on both production
  meshes, and the ``eval_shape`` trees of ``params_specs``, the AdamW
  state, ``input_specs`` and ``cache_specs`` for every live (arch x
  shape) pair (no compile);
* two reduced cells compiled on the 16x16 mesh, qwen3-8b's train_4k and
  decode_32k: ``memory_analysis``, the HLO text and its
  ``collective_stats`` summary and scan trip counts;
* ``extrapolate`` on fixed probe numbers.

In this process the port gives the same spec trees leaf for leaf, the
same shapes and dtypes, the same argument bytes, the same output bytes
but XLA's output-tuple index table (8 bytes a leaf), the same HLO
summary, and ``extrapolate`` bit for bit; and, by itself, ``corrected ==
main`` at every family's reduced config, the counting folds equal to the
full trace, its flops equal to ``FlopCounterMode``'s, and a reduced cell
run whole on the CPU.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import SHAPES, ShapeConfig, applicable
from repro_torch.configs.registry import ARCHS, get_config, reduced_config
from repro_torch.launch import cost, dryrun
from repro_torch.launch import sharding as shp
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models.model import cache_specs, input_specs, params_specs
from repro_torch.serve.serve_step import make_prefill_step
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_step import make_train_step
from repro_torch.utils import hlo
from repro_torch.utils.tree import leaves_with_paths

ROOT = Path(__file__).resolve().parent.parent
MESHES = {"16x16": False, "2x16x16": True}
CELLS = [("qwen3-8b", "train_4k"), ("qwen3-8b", "decode_32k")]
# one architecture of each family
FAMILIES = {"dense": "qwen3-8b", "moe": "qwen2-moe-a2.7b",
            "vlm": "qwen2-vl-7b", "ssm": "xlstm-1.3b",
            "encdec": "whisper-tiny", "hybrid": "jamba-1.5-large-398b"}
# fixed probe numbers for extrapolate, as the reference's analyze gives them
PROBES = {"probe_lo": {"flops": 1.5e12, "bytes_accessed": 3.25e9,
                       "collectives": {"total_bytes": 1000, "bytes_by_op": {
                           "all-gather": 600, "all-reduce": 400}}},
          "probe_hi": {"flops": 2.75e12, "bytes_accessed": 5.5e9,
                       "collectives": {"total_bytes": 1900, "bytes_by_op": {
                           "all-gather": 1100, "reduce-scatter": 800}}}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_REFERENCE = textwrap.dedent("""
    import dataclasses, json, sys
    import repro.launch.dryrun as D     # sets XLA_FLAGS before jax starts
    import jax
    from repro.configs.base import SHAPES, applicable
    from repro.configs.registry import ARCHS, get_config, reduced_config
    from repro.launch import sharding as shp
    from repro.launch.mesh import make_production_mesh, mesh_context
    from repro.models.model import cache_specs, input_specs, params_specs
    from repro.train.optimizer import adamw_init
    from repro.utils.hlo import scan_trip_counts

    out_dir = sys.argv[1]
    cells, probes = json.loads(sys.argv[2]), json.loads(sys.argv[3])

    def keys(path):
        return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)

    def flat(tree, fn, is_leaf=None):
        return {keys(p): fn(v) for p, v in
                jax.tree_util.tree_flatten_with_path(tree, is_leaf)[0]}

    def spec(s):
        return [list(e) if isinstance(e, tuple) else e for e in s]

    def specs(tree):
        return flat(tree, spec, lambda x: isinstance(
            x, jax.sharding.PartitionSpec))

    def sds(v):
        return [list(v.shape), str(v.dtype)]

    meta = {"specs": {}, "trees": {}, "cells": {}, "extrapolate": {}}
    meshes = {"16x16": make_production_mesh(),
              "2x16x16": make_production_mesh(multi_pod=True)}
    for arch in ARCHS:
        cfg = get_config(arch)
        p_shape = params_specs(cfg)
        o_shape = jax.eval_shape(lambda p: adamw_init(p, D.opt_config(cfg)),
                                 p_shape)
        live = [n for n, s in SHAPES.items() if applicable(cfg, s)[0]]
        trees = {"params": flat(p_shape, sds), "opt": flat(o_shape, sds)}
        for name in live:
            trees[name] = {"input": flat(input_specs(cfg, SHAPES[name]), sds)}
            if SHAPES[name].kind == "decode":
                trees[name]["cache"] = flat(
                    cache_specs(cfg, SHAPES[name]), sds)
        meta["trees"][arch] = trees
        for mname, mesh in meshes.items():
            p_specs = shp.param_specs(p_shape, cfg, mesh)
            rec = {"params": specs(p_specs),
                   "opt": specs(shp.opt_specs(o_shape, p_specs))}
            for name in live:
                shape = SHAPES[name]
                rec[name] = {"batch": specs(shp.batch_specs(
                    cfg, shape, mesh, input_specs(cfg, shape)))}
                if shape.kind == "decode":
                    rec[name]["cache"] = specs(shp.cache_specs_tree(
                        cfg, shape, mesh, cache_specs(cfg, shape)))
            meta["specs"][arch + "|" + mname] = rec
        g = D._group_size(cfg)
        meta["extrapolate"][arch] = D.extrapolate(cfg, probes, 1, 2, g)
    mesh = meshes["16x16"]
    for arch, name in cells:
        cfg = dataclasses.replace(reduced_config(arch), dp_axes=("data",),
                                  sp_axis="model", model_axis_size=16)
        with mesh_context(mesh):
            compiled = D.build_cell(cfg, SHAPES[name], mesh)().compile()
        text = compiled.as_text()
        with open(f"{out_dir}/{arch}_{name}.hlo", "w") as f:
            f.write(text)
        meta["cells"][arch + "|" + name] = dict(
            D.analyze(compiled), trips=scan_trip_counts(text))
    print(json.dumps(meta))
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's specs, trees, two compiled cells and extrapolations,
    once per module, in one subprocess."""
    tmp = tmp_path_factory.mktemp("sharding_ref")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(tmp), json.dumps(CELLS),
         json.dumps(PROBES)],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), tmp


def _spec(p) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in p]


def _specs(tree, specs) -> dict:
    """``{path: spec}`` of a spec tree, by the leaves of ``tree``."""
    return {path: _spec(shp.spec_at(specs, path))
            for path, _ in leaves_with_paths(tree)}


def _sds(tree) -> dict:
    return {path: [list(t.shape), str(t.dtype).replace("torch.", "")]
            for path, t in leaves_with_paths(tree)}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_spec_trees_match_reference(reference, arch):
    """``param_specs``, ``opt_specs``, ``batch_specs`` and
    ``cache_specs_tree`` at the published config equal the reference's
    leaf for leaf, on both production meshes, for every live shape."""
    cfg = get_config(arch)
    params = params_specs(cfg)
    opt = adamw_init(params, dryrun.opt_config(cfg))
    for mname, multi_pod in MESHES.items():
        want = reference[0]["specs"][f"{arch}|{mname}"]
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        p_specs = shp.param_specs(params, cfg, mesh)
        assert _specs(params, p_specs) == want["params"], mname
        assert _specs(opt, shp.opt_specs(opt, p_specs)) == want["opt"]
        for name, shape in SHAPES.items():
            if not applicable(cfg, shape)[0]:
                assert name not in want
                continue
            batch = input_specs(cfg, shape)
            assert _specs(batch, shp.batch_specs(cfg, shape, mesh, batch)) \
                == want[name]["batch"], (mname, name)
            if shape.kind == "decode":
                cache = cache_specs(cfg, shape)
                assert _specs(cache, shp.cache_specs_tree(
                    cfg, shape, mesh, cache)) == want[name]["cache"]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_meta_trees_match_reference_shapes(reference, arch):
    """``params_specs``, the AdamW state, ``input_specs`` and
    ``cache_specs`` on the meta device have the reference's
    ``eval_shape`` shapes and dtypes, leaf for leaf, for every live
    (arch x shape) pair."""
    cfg = get_config(arch)
    want = reference[0]["trees"][arch]
    params = params_specs(cfg)
    assert all(t.is_meta for _, t in leaves_with_paths(params))
    assert _sds(params) == want["params"]
    assert _sds(adamw_init(params, dryrun.opt_config(cfg))) == want["opt"]
    for name, shape in SHAPES.items():
        if not applicable(cfg, shape)[0]:
            continue
        assert _sds(input_specs(cfg, shape)) == want[name]["input"], name
        if shape.kind == "decode":
            assert _sds(cache_specs(cfg, shape)) == want[name]["cache"]


def _leaves(rec_out) -> int:
    return len(leaves_with_paths(rec_out))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_memory_and_hlo_summary_match_reference(reference, tmp_path, arch,
                                                shape):
    """On the reduced cell compiled for the 16x16 mesh: the port's
    ``argument_bytes`` equal ``memory_analysis``'s; its ``output_bytes``
    too, once XLA's output tuple index table (8 bytes for each of the
    step's output leaves) is added; the ported ``collective_stats`` gives
    the reference's summary of the same HLO text, and
    ``scan_trip_counts`` its trip counts."""
    meta, tmp = reference
    want = meta["cells"][f"{arch}|{shape}"]
    cfg = reduced_config(arch)
    rec = dryrun.run_cell(arch, shape, False, probes=False, cfg=cfg,
                          device="cpu", out_dir=str(tmp_path))
    memory = rec["main"]["memory"]
    assert memory["argument_bytes"] == want["memory"]["argument_bytes"]
    out = dryrun.count_step(cfg, SHAPES[shape])[2]
    assert memory["output_bytes"] + 8 * _leaves(out) \
        == want["memory"]["output_bytes"]
    text = (tmp / f"{arch}_{shape}.hlo").read_text()
    assert hlo.collective_stats(text).summary() == want["collectives"]
    assert hlo.scan_trip_counts(text) == want["trips"]


def test_extrapolate_matches_reference_bitwise(reference):
    """``extrapolate`` is arithmetic: the same probe numbers give the
    reference's result bit for bit at every published config."""
    for arch in ARCHS:
        cfg = get_config(arch)
        got = dryrun.extrapolate(cfg, PROBES, 1, 2, dryrun._group_size(cfg))
        assert json.loads(json.dumps(got)) == reference[0]["extrapolate"][
            arch], arch


@pytest.mark.parametrize("family", list(FAMILIES))
def test_corrected_equals_main_at_reduced_configs(tmp_path, family):
    """The port unrolls every layer: at each family's reduced config (one
    microbatch) the 1- and 2-group probes extrapolate to the full step's
    flops, bytes and collectives, in train (forward, backward and the
    optimizer) and in decode (prefill's forward is train's, sized by the
    same code)."""
    arch = FAMILIES[family]
    cfg = reduced_config(arch)
    for name in ("train_4k", "decode_32k"):
        rec = dryrun.run_cell(arch, name, True, cfg=cfg, device="cpu",
                              out_dir=str(tmp_path), verbose=False)
        main, corr = rec["main"], rec["corrected"]
        assert rec["ran"] == "meta" and main["flops"] > 0
        assert corr["flops"] == main["flops"], name
        assert corr["bytes_accessed"] == main["bytes_accessed"], name
        coll = main["collectives"]
        assert corr["collective_bytes"] == coll["total_bytes"], name
        assert corr["collective_by_op"] == {
            op: float(v) for op, v in coll["bytes_by_op"].items()}, name


def _full(fn, *args) -> tuple:
    counter = cost.StepCount()
    with counter:
        fn(*args)
    return counter.flops, counter.bytes


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_folded_time_loops_equal_the_full_trace(arch, kind):
    """The sLSTM's and the selective scan's loops, counted by
    ``fold_time_loops``'s quadratic rule at 448 tokens (folded: past the
    short lengths and a multiple of the scan's chunk), give the full
    trace's flops and bytes exactly; in train through the checkpointed
    blocks, recompute included."""
    cfg = reduced_config(arch)
    shape = ShapeConfig("fold", 448, 2, kind)
    batch = input_specs(cfg, shape)
    if kind == "train":
        ocfg = AdamWConfig(lr=1e-4)
        step = make_train_step(cfg, ocfg)

        def args():
            params = params_specs(cfg)
            return params, adamw_init(params, ocfg), batch
    else:
        step = make_prefill_step(cfg)

        def args():
            return params_specs(cfg), batch
    folded = cost.count(step, *args())
    assert folded[:2] == _full(step, *args())


def test_microbatch_fold_and_flop_counter():
    """A train step of 5 microbatches counted as C(2) + 3 (C(3) - C(2))
    equals its full trace; the counter's flops equal
    ``FlopCounterMode``'s over the same step."""
    cfg = dataclasses.replace(reduced_config("qwen2-moe-a2.7b"),
                              microbatches=5)
    shape = ShapeConfig("fold", 64, 10, "train")
    ocfg = AdamWConfig(lr=1e-4)
    folded = cost.count_train_step(cfg, shape, ocfg)
    full = cost.count_train_step(cfg, shape, ocfg, fold=False)
    assert folded[:2] == full[:2]
    params = params_specs(cfg)
    mode = FlopCounterMode(display=False)
    with mode:
        make_train_step(cfg, ocfg)(params, adamw_init(params, ocfg),
                                   input_specs(cfg, shape))
    assert full[0] == mode.get_total_flops()


def test_shard_shape_and_per_device_bytes():
    """``shard_shape`` divides each dim by its entry's device count and
    refuses one that does not divide; ``per_device_bytes`` sums the
    shards (a composite entry splits over both axes)."""
    mesh = make_test_mesh((2, 2, 4), ("pod", "data", "model"), device="meta")
    spec = shp.P(("pod", "data"), None, "model")
    assert shp.shard_shape((8, 3, 16), spec, mesh) == (2, 3, 4)
    assert shp.shard_shape((8,), shp.P(), mesh) == (8,)
    with pytest.raises(ValueError, match="divide"):
        shp.shard_shape((6, 3, 16), spec, mesh)
    tree = {"a": torch.empty((8, 3, 16), device="meta"),
            "b": [torch.empty((4,), dtype=torch.bfloat16, device="meta")]}
    specs = {"a": spec, "b": [shp.P("model")]}
    assert shp.per_device_bytes(tree, specs, mesh) == 2 * 3 * 4 * 4 + 1 * 2
    assert shp.P("data", None) == ("data", None)


def test_reduced_cell_runs_whole_on_the_cpu(tmp_path):
    """``run_cell`` with a reduced config and ``whole=True`` runs the
    cell at its own shape (xlstm, long_500k: one request at position
    524,287) on the CPU through the code the card runs, its check
    against the same step on CPU copies passing; without ``whole`` a
    CPU cell is sized only."""
    cfg = reduced_config("xlstm-1.3b")
    rec = dryrun.run_cell("xlstm-1.3b", "long_500k", False, probes=False,
                          cfg=cfg, device="cpu", whole=True, runs=1,
                          check=True, out_dir=str(tmp_path))
    assert rec["ran"] == "cpu" and rec["device"] == "cpu"
    assert rec["check"]["rows"] == 1 and rec["step_ms"] > 0
    assert rec["check"]["worst_share_of_bound"] <= 1.0
    rec = dryrun.run_cell("xlstm-1.3b", "long_500k", False, probes=False,
                          cfg=cfg, device="cpu", out_dir=str(tmp_path))
    assert rec["ran"] == "meta" and rec["why_meta"] == "device cpu"
    assert rec["plan"]["fits"] is None and rec["plan"]["need_gb"] > 0


def test_check_catches_a_wrong_answer():
    """``_check`` fails on a state leaf moved by 0.5 after the step, and
    on a decode token that is not the argmax of its logits."""
    cfg = reduced_config("xlstm-1.3b")
    shape = SHAPES["long_500k"]
    step = dryrun._make_step(cfg, shape)
    for leaf in ("state", "token"):
        args = dryrun._seeded(cfg, shape, torch.device("cpu"))
        cpu_args = tuple(dryrun._rows(a, 1, 1) for a in args)
        out = step(*args)
        if leaf == "state":
            out[2]["slstm"]["c"] += 0.5
            match = "card vs CPU"
        else:
            out = (out[0] + 1, *out[1:])
            match = "argmax"
        with pytest.raises(AssertionError, match=match):
            dryrun._check(cfg, shape, step, cpu_args, out, 1)
