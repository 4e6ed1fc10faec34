"""The train CLI on 2 ranks (gloo, the CPU) through the port's launcher
against one process at the same global batch (2 windows of a tiny child
of seqs_multigeo_4cm: its loaders, 3D augmentation and monitored top-3),
as tests/test_multiprocess.py holds the JAX launcher: train losses within
1e-5 relative, validation losses within 1e-4; rank 0 alone writes the
files and logs at INFO; a SIGTERM sent to one rank stops both after the
same step with one checkpoint, and a 2-rank resume from it runs to the end.
"""
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from gennerf_tpu_torch.data.make_multigeo import make_multigeo
from gennerf_tpu_torch.train.__main__ import main as train_main
from gennerf_tpu_torch.tools import launch_local

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = (
    "defaults:\n  - seqs_multigeo_4cm\n"
    "seed: 1\n"
    "model:\n  encoder:\n    pointnet:\n      num_sparse_points: 16\n      fps_presample: 32\n"
    "      c_dim: 8\n      hidden_dim: 8\n      plane_resolution: 8\n      n_blocks: 1\n"
    "      unet: false\n"
    "  mlp: {d_out_geo: 8, d_out_sem: 1, n_blocks: 1, d_hidden: 16}\n"
    "  ray: {num_rays: 8, N: 4, M: 2}\n"
    "trainer: {max_epochs: 2, log_every_n_steps: 1, check_val_every_n_epoch: 1,\n"
    "          num_sanity_val_steps: 2}\n"
    "data:\n  batch_size: 2\n  voxel_size: 0.08\n  voxel_dim_train: [16, 16, 8]\n"
    "  voxel_dim_val: [16, 16, 8]\n  voxel_dim_test: [16, 16, 8]\n  num_frames_train: 2\n"
    "  num_frames_val: 2\n  num_frames_test: 2\n  sequence_length: 3\n"
    "  num_workers_train: 2\n  num_workers_val: 2\n  num_workers_test: 2\n")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("multigeo"))
    make_multigeo(root, train=2, frames=9, height=24, width=32, voxel_sizes=(8,))
    return root


@pytest.fixture(scope="module")
def tiny_config(tmp_path_factory):
    root = tmp_path_factory.mktemp("configs")
    shutil.copytree(os.path.join(REPO, "configs"), root / "configs")
    exp = root / "configs" / "experiment" / "tiny_parallel.yaml"
    exp.write_text(TINY)
    return str(exp)


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "GENNERF_NUM_PROCESSES")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return env


def _losses(out):
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    return ([r["train_combined"] for r in rows if "train_combined" in r],
            [r["val_combined"] for r in rows if "val_combined" in r])


def _launch(args, log_dir, n=2, timeout=300):
    return subprocess.run([sys.executable, "-m", "gennerf_tpu_torch.tools.launch_local", "-n",
                           str(n), "--log-dir", str(log_dir), "--", *args], env=_env(),
                          timeout=timeout, capture_output=True, text=True)


def test_launcher_two_ranks_match_one_process(tiny_config, dataset, tmp_path):
    """2 epochs: the same train and validation losses, the same final
    weights (within 1e-5, a hundredth of the learning rate); the files are
    rank 0's and rank 1 logs nothing at INFO."""
    common = ["--config", tiny_config, "--data-dir", dataset, "--device", "cpu"]
    train_main([*common, "--out", str(tmp_path / "one")])
    two = tmp_path / "two"
    run = _launch([*common, "--out", str(two), "trainer.devices=2"], tmp_path / "logs")
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    train_1, val_1 = _losses(tmp_path / "one")
    train_2, val_2 = _losses(two)
    assert len(train_1) == len(train_2) == 6 and len(val_1) == len(val_2) == 2
    np.testing.assert_allclose(train_2, train_1, rtol=1e-5)
    np.testing.assert_allclose(val_2, val_1, rtol=1e-4)
    assert "trained 6 steps" in run.stdout
    with np.load(tmp_path / "one" / "params.npz") as f1, np.load(two / "params.npz") as f2:
        assert set(f1.files) == set(f2.files)
        for k in f1.files:  # Adam moves a parameter by lr at most a step (lr 1e-3)
            np.testing.assert_allclose(f2[k], f1[k], rtol=0, atol=1e-5, err_msg=k)
    ranking = json.loads((two / "checkpoints" / "checkpoints.json").read_text())
    assert sorted(ranking["ranked"]) == ["0", "1"]
    rank1 = (tmp_path / "logs" / "rank1.log").read_text()
    assert "[rank1][INFO]" not in rank1 and "trained" not in rank1


def test_launch_local_cli_surface():
    assert launch_local.free_port() > 0
    with pytest.raises(SystemExit):
        launch_local.main(["--help"])


def test_sigterm_to_one_rank_stops_both_then_resume(tiny_config, dataset, tmp_path):
    """SIGTERM to rank 1 alone once rank 0 has logged a step: both ranks
    save nothing twice, exit 0 after the same step, and a 2-rank resume
    continues at the next epoch to max_epochs."""
    out = tmp_path / "run"
    args = ["-m", "gennerf_tpu_torch.train", "--config", tiny_config, "--data-dir", dataset,
            "--device", "cpu", "--out", str(out), "trainer.max_epochs=40", "trainer.devices=2"]
    coordinator = f"localhost:{launch_local.free_port()}"
    procs = []
    for rank in range(2):
        env = dict(_env(), GENNERF_COORDINATOR=coordinator, GENNERF_NUM_PROCESSES="2",
                   GENNERF_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, *args], env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    deadline = time.time() + 120
    while not (out / "metrics.jsonl").exists() and time.time() < deadline:
        time.sleep(0.1)
    procs[1].send_signal(signal.SIGTERM)
    outputs = [p.communicate(timeout=180)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outputs[0][-3000:] + outputs[1][-3000:]
    said = [line for line in outputs[0].splitlines() if line.startswith("preempted at step")]
    assert len(said) == 1
    step = int(said[0].split()[3].rstrip(":"))
    saved = torch.load(out / "checkpoints" / "last.pt", weights_only=False)
    assert saved["step"] == step and saved["epoch"] < 39
    resumed = _launch(["--config", tiny_config, "--data-dir", dataset, "--device", "cpu",
                       "--out", str(tmp_path / "resumed"), "--resume", str(out),
                       f"trainer.max_epochs={saved['epoch'] + 2}", "trainer.devices=2"],
                      tmp_path / "logs")
    assert resumed.returncode == 0, resumed.stdout[-3000:] + resumed.stderr[-3000:]
    assert f"resumed from {out}" in resumed.stdout
    assert "trained" in resumed.stdout
    rows = [json.loads(line) for line in open(tmp_path / "resumed" / "metrics.jsonl")]
    assert {r["epoch"] for r in rows if "epoch" in r} == {saved["epoch"] + 1}
