"""The port's five examples (``examples/torch_*.py``) on the CPU, each in
its own process with ``--device cpu`` and ``jax`` and ``repro`` blocked,
side by side (one module-scoped run of ``chip_smoke.launch_examples``),
their quality lines held to the bars ``chip_smoke.py`` phase 12 holds
them to on the card (``chip_smoke.check_example``): same-cluster rate,
recovery of every live point and of the graph's edge set, the
time-to-flag ratio. ``serve_gus`` runs at ``--points 800 --requests 10``;
the others at their own sizes.
"""
import pytest

import chip_smoke

ARGS = dict(chip_smoke.EXAMPLES,
            serve_gus=("--points", "800", "--requests", "10"))


@pytest.fixture(scope="module")
def runs():
    return chip_smoke.launch_examples(("--device", "cpu"), ARGS,
                                      timeout=110)


@pytest.mark.parametrize("name", sorted(chip_smoke.EXAMPLES))
def test_example_runs_on_the_cpu_without_jax(runs, name):
    out, _ = runs[name]
    assert out.returncode == 0, out.stderr[-3000:]
    got = chip_smoke.check_example(name, out.stdout)
    if name == "serve_gus":
        assert len(got["quality"]) == 1
