"""On a card: one run of each cell through the command line, correct and
with its metrics (skips without a card; run there with
`python -m pytest --noconftest portbench/tests/test_portbench_card.py`)."""
import json
import subprocess
import sys

import pytest

from portbench.core import spec


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in spec.load_benchmark()["workloads"]
                                  if w["chips"] == 1])
def test_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell, "--seed",
                          str(2**31 + 77), "--seconds", "3", "--trace", "0"], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and "setup_s" in line["metrics"]
