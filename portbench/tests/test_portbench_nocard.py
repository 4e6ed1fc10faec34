"""A run fails, rather than falling back, without a card, and fails in a
directory that holds only BENCHMARK.json and the benchmark's files."""
import os
import shutil
import subprocess
import sys

from portbench.core import spec

PATCHED = r"""
import sys, torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 4
torch.cuda.set_device = lambda d: None
from portbench import run
sys.exit(run.main(["--workload", "gennerf_living.recon", "--seed", "1", "--seconds", "1",
                   "--trace", "0"]))
"""


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "gennerf_living.recon", "--seed", str(2**31 + 9), "--seconds", "1",
                          "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copytree(spec.PKG, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PATCHED], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "gennerf_tpu_torch" in out.stderr
