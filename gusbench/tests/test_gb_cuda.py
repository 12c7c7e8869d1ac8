"""On the card: each cell's command, run from the checkout's root for a short
window, prints a correct result line. Skips without a card."""
import json
import subprocess
import sys

import pytest
import torch


@pytest.mark.cuda
@pytest.mark.parametrize("cell,trace", [("arxiv-index.reads", 0),
                                        ("arxiv-index.bulk", 1)])
def test_cell_runs_correct_on_the_card(root, cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "gusbench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "3", "--trace", str(trace)],
        cwd=root, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "checks"


def test_without_a_card_the_command_prints_no_result(root, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("the card is there")
    proc = subprocess.run(
        [sys.executable, "gusbench/run.py", "--workload",
         "arxiv-index.reads", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=root, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
