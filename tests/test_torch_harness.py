"""The port's training harness against the JAX `Trainer` on the CPU: the
train CLI's root keys (F8: `seed` from the config, `train: false`,
`ckpt_path`, an unknown key), the batch limits, early stopping, the
SIGTERM save, the profiler window and the sweep, at a small size.

Where the JAX Trainer is the reference, both sides run with their steps
replaced by recorders (the JAX task's init_state / run_train_step /
run_eval_step / reconstruct, the port loop's train_step / eval_step /
reconstruction tail) and checkpoint managers that record what they are
asked to save, on the same small multigeo dataset, so that what is
compared is the data stream batch by batch (within 1e-6: the loaders
compute in numpy on both sides), the epoch a fit stops in, its steps and
the epochs it saves. The subprocess, profiler and sweep cases run the
port alone, with real steps of a tiny GenNerf.
"""
import csv
import json
import os
import shutil
import signal
import subprocess
import sys
import time
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu.data import datamodule as jdm
from gennerf_tpu.train.loggers import MetricsLogger, get_logger
from gennerf_tpu.train.loop import Trainer as JTrainer
from gennerf_tpu.train.state import create_train_state
from gennerf_tpu.train.tasks import GenNerfTask
from gennerf_tpu_torch.data import datamodule as tdm
from gennerf_tpu_torch.data.make_multigeo import make_multigeo
from gennerf_tpu_torch.predict import build_model
from gennerf_tpu_torch.train import loop
from gennerf_tpu_torch.train.__main__ import main as train_main
from gennerf_tpu_torch.train.checkpoints import load_checkpoint
from gennerf_tpu_torch.train.state import make_optimizer
from gennerf_tpu_torch.utils.config import load_experiment_config

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = dict(
    datasets_train=["train.txt"], datasets_val=["val.txt"], datasets_test=["val.txt"],
    batch_size=1, dataset_type="sequences", sequence_amount_train=1.0, sequence_amount_val=2.0,
    sequence_amount_test=1.0, sequence_length=3, sequence_locations="free",
    sequence_order="random", num_frames_train=2, num_frames_val=2, num_frames_test=2,
    frame_locations="evenly_spaced", frame_order="random", voxel_size=0.08,
    voxel_dim_train=[16, 16, 8], voxel_dim_val=[16, 16, 8], voxel_dim_test=[16, 16, 8],
    num_workers_train=2, num_workers_val=2)
MODEL = {
    "type": "GenNerf", "voxel_size": 0.08, "voxel_dim_train": [16, 16, 8],
    "voxel_dim_val": [16, 16, 8], "voxel_dim_test": [16, 16, 8],
    "encoder": {"use_spatial": False, "use_pointnet": True,
                "pointnet": {"num_sparse_points": 16, "fps_presample": 32, "c_dim": 8,
                             "hidden_dim": 8, "plane_resolution": 8, "n_blocks": 1,
                             "unet": False}},
    "mlp": {"d_out_sem": 1, "d_out_geo": 8, "n_blocks": 1, "d_hidden": 16},
}
# a child of seqs_multigeo_4cm (its loaders, 3D augmentation and monitored
# top-3) at a tiny width, with `seed: 1`
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
    "data:\n  voxel_size: 0.08\n  voxel_dim_train: [16, 16, 8]\n  voxel_dim_val: [16, 16, 8]\n"
    "  voxel_dim_test: [16, 16, 8]\n  num_frames_train: 2\n  num_frames_val: 2\n"
    "  num_frames_test: 2\n  sequence_length: 3\n  num_workers_train: 2\n"
    "  num_workers_val: 2\n  num_workers_test: 2\n")
# YAML 1.1 reads 1e-3 as a string: the values carry a decimal point
TINY_GRID = ("method: grid\nmetric: val_combined\n"
             "parameters:\n  model.optimizer.lr: {values: [1.0e-3, 1.0e-4]}\n")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """2 training scenes (6 windows an epoch) and the 2 held-out ones, 9
    frames of 24x32, ground truth at 8 cm."""
    root = str(tmp_path_factory.mktemp("multigeo"))
    make_multigeo(root, train=2, frames=9, height=24, width=32, voxel_sizes=(8,))
    return root


@pytest.fixture(scope="module")
def tiny_config(tmp_path_factory):
    """TINY and a 2-point hparams_search group in a copy of the configs tree."""
    root = tmp_path_factory.mktemp("configs")
    shutil.copytree(os.path.join(REPO, "configs"), root / "configs")
    (root / "configs" / "hparams_search" / "tiny_grid.yaml").write_text(TINY_GRID)
    exp = root / "configs" / "experiment" / "tiny_harness.yaml"
    exp.write_text(TINY)
    return str(exp)


class RecordingCheckpoints:
    """Stands in for either package's checkpoint manager: records the
    epoch and the monitored metrics of each save."""

    def __init__(self):
        self.saved = []

    def save(self, epoch, *args, metrics=None, **kwargs):
        self.saved.append((int(epoch), None if metrics is None else dict(metrics)))

    def wait(self):
        pass


def _record(store, batch):
    store.append({k: np.array(batch[k]) for k in ("pose", "projection")})


def _streams(sigterm_at=None, script=None):
    """The recorder state and the three recorders' shared behaviour: a
    SIGTERM sent from inside train step `sigterm_at`; eval step i returns
    combined = script(i)."""
    rec = {"train": [], "eval": [], "tail": []}

    def on_train(batch):
        _record(rec["train"], batch)
        if sigterm_at == len(rec["train"]):
            os.kill(os.getpid(), signal.SIGTERM)

    def on_eval(batch):
        _record(rec["eval"], batch)
        return 1.0 if script is None else float(script(len(rec["eval"]) - 1))

    return rec, on_train, on_eval


def jax_fit(dataset, seed=4, max_epochs=3, sigterm_at=None, script=None, data=None, **kw):
    """The JAX Trainer's streams, its checkpoint saves and the trainer."""
    rec, on_train, on_eval = _streams(sigterm_at, script)
    task = GenNerfTask(MODEL)
    task.init_state = lambda key, batch: create_train_state({"params": {"w": jnp.zeros(3)}},
                                                            task.tx)
    task.run_train_step = lambda state, batch, key: (on_train(batch) or state,
                                                     {"combined": jnp.ones(())})
    task.run_eval_step = lambda state, batch, key: {"combined": jnp.asarray(on_eval(batch))}

    def tail(state, batch, b_idx=0):
        _record(rec["tail"], batch)
        raise RuntimeError("no reconstruction in this test")

    task.reconstruct = tail
    ckpt = RecordingCheckpoints()
    out = os.path.join(dataset, f"jax_{time.monotonic_ns()}")
    trainer = JTrainer(max_epochs=max_epochs, devices=1, precision="32-true", log_every_n_steps=1,
                       prefetch_batches=0, output_dir=out, logger=MetricsLogger(out), ckpt=ckpt,
                       **kw)
    trainer.fit(task, jdm.ScannetDataModule(data or dict(DATA, data_dir=dataset), seed=seed),
                seed=seed)
    return rec, ckpt.saved, trainer


def _patch_port_steps(monkeypatch, sigterm_at=None, script=None):
    rec, on_train, on_eval = _streams(sigterm_at, script)
    monkeypatch.setattr(loop, "train_step", lambda model, opt, batch, gen=None: (
        on_train(batch), {"combined": torch.ones(())})[1])
    monkeypatch.setattr(loop, "eval_step", lambda model, batch, gen=None: {
        "combined": torch.tensor(on_eval(batch))})
    monkeypatch.setattr(loop.Trainer, "_reconstruction_tail", lambda self, batch, mode, step=0: (
        _record(rec["tail"], batch), {})[1])
    return rec


def port_fit(dataset, monkeypatch, seed=4, max_epochs=3, sigterm_at=None, script=None,
             trainer_cfg=None, callbacks_cfg=None):
    """The port's streams, its checkpoint saves and the trainer, the train
    CLI's way: the loaders of ScannetDataModule, the settings from
    trainer_options."""
    rec = _patch_port_steps(monkeypatch, sigterm_at, script)
    model = build_model(MODEL, "cpu")
    options = loop.trainer_options(dict({"max_epochs": max_epochs, "log_every_n_steps": 1,
                                         "precision": "32-true"}, **(trainer_cfg or {})),
                                   callbacks_cfg)
    opt = make_optimizer(model.parameters(), model.cfg.optimizer, options.pop("gradient_clip_val"))
    mod = tdm.ScannetDataModule(dict(DATA, data_dir=dataset), seed=seed)
    ckpt = RecordingCheckpoints()
    trainer = loop.Trainer(model, opt, torch.Generator().manual_seed(seed), None,
                           checkpoints=ckpt, **options)
    trainer.fit(mod.train_dataloader(), mod.val_dataloader())
    return rec, ckpt.saved, trainer


def _assert_same(ours, ref, what):
    assert len(ours) == len(ref), (what, len(ours), len(ref))
    for i, (o, r) in enumerate(zip(ours, ref)):
        for k in r:
            np.testing.assert_allclose(o[k], r[k], rtol=0, atol=1e-6, err_msg=f"{what} {i} {k}")


# -- F8: the train CLI's root keys -------------------------------------------------

def _jax_config_batches(tiny_config, dataset):
    """The JAX Trainer's streams for the tiny config's data at its seed 1."""
    cfg = load_experiment_config(tiny_config, "train", [f"paths.data_dir={dataset}"])
    assert cfg["seed"] == 1
    t = cfg["trainer"]
    rec, _, _ = jax_fit(dataset, seed=cfg["seed"], max_epochs=t["max_epochs"],
                        data=cfg["data"], num_sanity_val_steps=t["num_sanity_val_steps"],
                        save_on_preempt=False)
    return rec


def test_config_seed_gives_the_jax_batches(tiny_config, dataset, tmp_path, monkeypatch):
    """F8: the config's `seed: 1` with no --seed seeds the loaders (and the
    step generator) as the JAX CLI does: the train, eval and tail batches
    of a 2-epoch fit with its sanity pass equal the JAX Trainer's at seed
    1. The parent seeded them from --seed's default 0."""
    ref = _jax_config_batches(tiny_config, dataset)
    rec = _patch_port_steps(monkeypatch)
    trainer = train_main(["--config", tiny_config, "--out", str(tmp_path / "run"),
                          "--data-dir", dataset, "--device", "cpu"])
    for what in ("train", "eval", "tail"):
        _assert_same(rec[what], ref[what], what)
    assert len(ref["train"]) == 2 * 6 and len(ref["tail"]) == 2
    assert trainer.generator.initial_seed() == 1


@pytest.fixture
def first_run(tiny_config, dataset, tmp_path, monkeypatch):
    """A 2-epoch run of the CLI at --seed 5 (recorded steps: the weights stay
    the seed-5 initialisation); returns its directory and final step."""
    _patch_port_steps(monkeypatch)
    out = tmp_path / "first"
    trainer = train_main(["--config", tiny_config, "--out", str(out), "--data-dir", dataset,
                          "--device", "cpu", "--seed", "5"])
    return out, trainer.global_step, {k: v.clone() for k, v in trainer.model.state_dict().items()}


def test_train_false_restores_and_tests(first_run, tiny_config, dataset, tmp_path, monkeypatch):
    """F8: `train: false` with `ckpt_path` trains nothing; the checkpoint's
    weights (seed 5's, not this run's seed 1) and step are restored and
    only the test pass runs (its batches and tail), logging test_*."""
    out, step, weights = first_run
    rec = _patch_port_steps(monkeypatch)
    run = tmp_path / "test_only"
    trainer = train_main(["--config", tiny_config, "--out", str(run), "--data-dir", dataset,
                          "--device", "cpu", "train=false", "test=true",
                          f"ckpt_path={out / 'checkpoints'}"])
    n_test = len(tdm.ScannetDataModule(dict(DATA, data_dir=dataset), seed=1).test_dataloader())
    assert rec["train"] == [] and len(rec["eval"]) == n_test and len(rec["tail"]) == 1
    assert trainer.global_step == step
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, weights[k]), k
    assert "test_combined" in trainer.metrics
    assert not (run / "params.npz").exists()


def test_ckpt_path_resumes(first_run, tiny_config, dataset, tmp_path, monkeypatch):
    """F8: `ckpt_path` resumes as --resume does: a 3-epoch run from the
    2-epoch run's checkpoints trains epoch 2 only; --resume and a different
    ckpt_path raise; an unknown root key warns."""
    out, step, _ = first_run
    rec = _patch_port_steps(monkeypatch)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trainer = train_main(["--config", tiny_config, "--out", str(tmp_path / "resumed"),
                              "--data-dir", dataset, "--device", "cpu",
                              f"ckpt_path={out / 'checkpoints'}", "trainer.max_epochs=3",
                              "not_a_key=1"])
    assert len(rec["train"]) == 6 and trainer.global_step == step + 6
    assert any("unknown root config key" in str(w.message) and "not_a_key" in str(w.message)
               for w in caught)
    info = load_checkpoint(str(tmp_path / "resumed" / "checkpoints" / "last.pt"),
                           build_model(trainer.model.cfg, "cpu"))
    assert info["epoch"] == 2
    with pytest.raises(ValueError, match="differ"):
        train_main(["--config", tiny_config, "--out", str(tmp_path / "x"), "--data-dir",
                    dataset, "--device", "cpu", "--resume", str(out),
                    f"ckpt_path={out / 'checkpoints'}"])


# -- batch limits ------------------------------------------------------------------

class _Unsized:
    def __iter__(self):
        return iter(range(6))


@pytest.mark.parametrize("limit,loader,expected", [
    (2, range(6), 2), (0.5, range(6), 3), (0.34, range(6), 3), (1.0, range(6), None),
    (0.0, range(6), 0), (None, range(6), None), (1.5, range(6), ValueError),
    (-0.5, range(6), ValueError), (0.5, _Unsized(), UserWarning)])
def test_batch_limit_as_jax(limit, loader, expected):
    """An int is a count, a fraction of a sized loader rounds up, 1.0 and
    None are no limit, a fraction outside [0, 1] raises, an unsized loader
    runs everything (the port warns; the JAX package logs)."""
    jax_self = types.SimpleNamespace(log=get_logger())
    if expected is ValueError:
        for fn in (loop.batch_limit, lambda *a: JTrainer._batch_limit(jax_self, *a)):
            with pytest.raises(ValueError, match="must be in"):
                fn(limit, loader)
        return
    ref = JTrainer._batch_limit(jax_self, limit, loader)
    if expected is UserWarning:
        with pytest.warns(UserWarning, match="sized loader"):
            assert loop.batch_limit(limit, loader) is None is ref
        return
    assert loop.batch_limit(limit, loader) == ref == expected


@pytest.mark.parametrize("limit_train", [2, 0.5])
def test_batch_limits_feed_the_jax_batches(dataset, monkeypatch, limit_train):
    """limit_train_batches (2, or half of 6 windows) and limit_val_batches 1
    over a 3-epoch fit with a 2-batch sanity pass: the train batches, the
    eval batches and the tails' batches (the last batch taken) equal the
    JAX Trainer's."""
    limits = {"limit_train_batches": limit_train, "limit_val_batches": 1,
              "num_sanity_val_steps": 2}
    ref, ref_saved, _ = jax_fit(dataset, save_on_preempt=False, **limits)
    rec, saved, trainer = port_fit(dataset, monkeypatch, trainer_cfg=limits)
    for what in ("train", "eval", "tail"):
        _assert_same(rec[what], ref[what], what)
    per_epoch = 2 if limit_train == 2 else 3
    assert len(rec["train"]) == 3 * per_epoch and len(rec["eval"]) == 2 + 3
    assert len(rec["tail"]) == 3 and trainer.global_step == 3 * per_epoch
    assert [e for e, _ in saved] == [e for e, _ in ref_saved] == [0, 1, 2]


# -- early stopping ----------------------------------------------------------------

@pytest.mark.parametrize("mode,patience,min_epochs,values,stop", [
    ("min", 1, 1, [3, 2, 2.5, 1, 0.5, 0.4], 2),
    ("max", 2, 1, [1, 2, 1.5, 1.8, 3, 4], 3),
    ("min", 1, 3, [1, 2, 3, 0.5, 4, 5], 4),
    ("min", 1, 1, [1, 1, 1, 1, 1, 1], 1),
])
def test_early_stopping_as_jax(dataset, monkeypatch, mode, patience, min_epochs, values, stop):
    """Both trainers read the same scripted val_combined (one validation
    batch an epoch) and stop in the same epoch, after saving the same
    epochs with the same metrics: min and max mode, the min_epochs gate,
    a tie counting as stale."""
    limits = {"limit_train_batches": 1, "limit_val_batches": 1, "num_sanity_val_steps": 0}
    es = {"monitor": "val_combined", "patience": patience, "mode": mode}
    script = values.__getitem__
    ref, ref_saved, _ = jax_fit(dataset, max_epochs=6, script=script, save_on_preempt=False,
                                min_epochs=min_epochs, early_stopping_monitor="val_combined",
                                early_stopping_patience=patience, early_stopping_mode=mode,
                                **limits)
    rec, saved, trainer = port_fit(dataset, monkeypatch, max_epochs=6, script=script,
                                   trainer_cfg=dict(limits, min_epochs=min_epochs),
                                   callbacks_cfg={"early_stopping": es})
    assert trainer.early_stopping_mode == mode and trainer.early_stopping_patience == patience
    assert saved == ref_saved and [e for e, _ in saved] == list(range(stop + 1))
    assert len(rec["train"]) == len(ref["train"]) == stop + 1


def test_early_stopping_absent_monitor_warns(dataset, monkeypatch):
    """A monitor missing from the validation metrics warns each validation
    and never stops the fit, as in JAX; the trainer keys win over the
    callbacks group's."""
    options = loop.trainer_options({"early_stopping_patience": 5},
                                   {"early_stopping": {"monitor": "val_x", "patience": 1,
                                                       "mode": "max"}})
    assert (options["early_stopping_monitor"], options["early_stopping_patience"],
            options["early_stopping_mode"]) == ("val_x", 5, "max")
    limits = {"limit_train_batches": 1, "limit_val_batches": 1, "num_sanity_val_steps": 0}
    _, ref_saved, _ = jax_fit(dataset, max_epochs=3, save_on_preempt=False,
                              early_stopping_monitor="val_absent", early_stopping_patience=1,
                              **limits)
    with pytest.warns(UserWarning, match="val_absent") as record:
        _, saved, _ = port_fit(dataset, monkeypatch, max_epochs=3, trainer_cfg=dict(
            limits, early_stopping_monitor="val_absent", early_stopping_patience=1))
    assert len([w for w in record if "val_absent" in str(w.message)]) == 3
    assert saved == ref_saved and len(saved) == 3
    with pytest.raises(ValueError, match="early_stopping_mode"):
        port_fit(dataset, monkeypatch, trainer_cfg={"early_stopping_mode": "median"})


# -- the SIGTERM save --------------------------------------------------------------

def test_sigterm_saves_at_the_step_boundary_as_jax(dataset, monkeypatch):
    """A SIGTERM sent from inside step 5 (epoch 1 of 3-step epochs): both
    trainers finish that step, save epoch 1 without metrics and stop; the
    handler installed before the fit is back after it."""
    limits = {"limit_train_batches": 3, "limit_val_batches": 1, "num_sanity_val_steps": 0}
    calls = []

    def before(signum, frame):
        calls.append(signum)

    previous = signal.signal(signal.SIGTERM, before)
    try:
        ref, ref_saved, jtrainer = jax_fit(dataset, max_epochs=4, sigterm_at=5, **limits)
        assert signal.getsignal(signal.SIGTERM) is before
        rec, saved, trainer = port_fit(dataset, monkeypatch, max_epochs=4, sigterm_at=5,
                                       trainer_cfg=limits)
        assert signal.getsignal(signal.SIGTERM) is before
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert jtrainer._preempted and trainer.preempted and calls == []
    assert len(rec["train"]) == len(ref["train"]) == 5 and trainer.global_step == 5
    assert saved == ref_saved == [(0, {"val_combined": 1.0}), (1, None)]
    _assert_same(rec["train"], ref["train"], "train")


def _csv_rows(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return list(csv.DictReader(f))


def _logged_step(path) -> int:
    """The largest step in a metrics.csv being written (0 while a row is
    incomplete)."""
    try:
        return max((int(float(r["step"])) for r in _csv_rows(path)), default=0)
    except (TypeError, ValueError):
        return 0


def test_sigterm_cli_saves_and_resumes(tiny_config, dataset, tmp_path):
    """`python -m gennerf_tpu_torch.train` at a tiny width: a SIGTERM once
    metrics.csv shows step 2 exits 0 without a test pass, after saving the
    interrupted epoch at the last logged step; --resume continues at the
    next epoch with a finite loss."""
    out = tmp_path / "run"
    args = ["--config", tiny_config, "--data-dir", dataset, "--device", "cpu",
            "trainer.max_epochs=50", "trainer.num_sanity_val_steps=0", "test=true"]
    proc = subprocess.Popen([sys.executable, "-m", "gennerf_tpu_torch.train", "--out", str(out),
                             *args], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        deadline = time.monotonic() + 120
        while _logged_step(out / "metrics.csv") < 2:
            assert proc.poll() is None and time.monotonic() < deadline, "no step 2"
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        log, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, log[-3000:]
    assert "SIGTERM: checkpointing" in log and "preempted at step" in log, log[-3000:]
    rows = _csv_rows(out / "metrics.csv")
    assert not any(k.startswith("test_") and v for r in rows for k, v in r.items())
    last_step = max(int(float(r["step"])) for r in rows)
    last_epoch = max(int(float(r["epoch"])) for r in rows if r.get("epoch"))
    model = build_model(load_experiment_config(tiny_config, "train")["model"], "cpu")
    info = load_checkpoint(str(out / "checkpoints" / "last.pt"), model)
    assert info == {"epoch": last_epoch, "step": last_step}
    resumed = train_main(["--out", str(tmp_path / "resumed"), "--resume", str(out), *args[:-1],
                          f"trainer.max_epochs={last_epoch + 2}"])
    rows = _csv_rows(tmp_path / "resumed" / "metrics.csv")
    epochs = {int(float(r["epoch"])) for r in rows if r.get("epoch")}
    assert epochs == {last_epoch + 1} and resumed.global_step == last_step + 6
    assert np.isfinite(resumed.metrics["train_combined"])


# -- the profiler window and the sweep ---------------------------------------------

def test_profiler_writes_a_cpu_trace(tmp_path, monkeypatch):
    """profile_dir with profile_steps 2: a Chrome trace of global steps 1
    to 3 (three steps' products), written into profile_dir."""
    product = torch.ones(32, 32)

    def step(model, opt, batch, gen=None):
        torch.mm(product, product)
        return {"combined": torch.ones(())}

    monkeypatch.setattr(loop, "train_step", step)
    model = build_model(MODEL, "cpu")
    trainer = loop.Trainer(model, make_optimizer(model.parameters(), model.cfg.optimizer, None),
                           torch.Generator().manual_seed(0), None, max_epochs=1,
                           log_every_n_steps=1, profile_dir=str(tmp_path / "prof"),
                           profile_steps=2)
    trainer.fit([{}] * 6)
    assert trainer.profile_trace == str(tmp_path / "prof" / "trace_steps1-3.json")
    with open(trainer.profile_trace) as f:
        events = json.load(f)["traceEvents"]
    assert len([e for e in events if e.get("name") == "aten::mm"]) == 3


def test_profiler_trace_holds_the_step_spans(dataset, tmp_path):
    """With real steps of the tiny GenNerf, the profile window's Chrome
    trace holds the program's spans of each step (utils/spans.py): the
    step, and inside it the forward, backward, all-reduce and optimizer."""
    model = build_model(MODEL, "cpu")
    mod = tdm.ScannetDataModule(dict(DATA, data_dir=dataset), seed=4)
    trainer = loop.Trainer(model, make_optimizer(model.parameters(), model.cfg.optimizer, None),
                           torch.Generator().manual_seed(0), None, max_epochs=1,
                           log_every_n_steps=1, limit_train_batches=3,
                           profile_dir=str(tmp_path / "prof"), profile_steps=1)
    trainer.fit(mod.train_dataloader())
    with open(trainer.profile_trace) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events]
    for span in ("gennerf.step", "gennerf.forward", "gennerf.encode", "gennerf.backward",
                 "gennerf.allreduce", "gennerf.optimizer"):
        assert names.count(span) == 2, span


def test_hparams_search_runs_a_two_trial_sweep(tiny_config, dataset, tmp_path):
    """`hparams_search=tiny_grid` hands the run to the sweep: two trials over
    model.optimizer.lr, one epoch of one batch each with real steps and
    the many_loggers group; each record has a finite val_combined, each
    trial directory its tensorboard events and the tail's comparison
    renders; sweep_results.jsonl holds both records."""
    out = tmp_path / "sweep"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        results = train_main(["--config", tiny_config, "--out", str(out), "--data-dir", dataset,
                              "--device", "cpu", "hparams_search=tiny_grid",
                              "trainer.max_epochs=1", "trainer.limit_train_batches=1",
                              "trainer.limit_val_batches=1", "trainer.num_sanity_val_steps=0",
                              "logger=many_loggers"])
    assert [r["params"] for r in results] == [{"model.optimizer.lr": 1e-3},
                                              {"model.optimizer.lr": 1e-4}]
    assert all(np.isfinite(r["metrics"]["val_combined"]) for r in results), results
    with open(out / "sweep_results.jsonl") as f:
        assert [json.loads(line) for line in f] == results
    for i in range(2):
        trial = out / f"trial_{i:03d}"
        assert os.listdir(trial / "tensorboard")
        for name in ("overview", "frame0", "frame1"):
            assert (trial / "local" / "val_render" / f"{name}.png").is_file()
