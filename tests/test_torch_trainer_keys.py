"""The train CLI's trainer and callback keys (the F7 repair) on the CPU: the
batches a fit feeds its steps equal the JAX `Trainer`'s, over the sanity
pass (num_sanity_val_steps 2), a 2-epoch fit and its validations, on a
small multigeo dataset with random frame order; every trainer and
callback key is ported (the harness keys pass through to the Trainer),
accepted or raises NotImplementedError naming it (more than one device);
an unknown key warns; both distillation experiments (min_epochs 10, no
early stopping) read through; a zero `*_coverage` warns at the epoch's
end.

The steps are replaced by recorders on both sides (the JAX task's
run_train_step / run_eval_step / init_state / reconstruct, the port loop's
train_step / eval_step / reconstruction tail), so no model runs: what is
compared is the data stream, batch by batch, within 1e-6 (the loaders
compute in numpy on both sides).
"""
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu.data import datamodule as jdm
from gennerf_tpu.train.loop import Trainer as JTrainer
from gennerf_tpu.train.loggers import MetricsLogger
from gennerf_tpu.train.state import create_train_state
from gennerf_tpu.train.tasks import GenNerfTask
from gennerf_tpu_torch.data import datamodule as tdm
from gennerf_tpu_torch.data.make_multigeo import make_multigeo
from gennerf_tpu_torch.predict import build_model
from gennerf_tpu_torch.train import loop
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


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """2 training scenes and the 2 held-out ones, 5 frames of 24x32."""
    root = str(tmp_path_factory.mktemp("multigeo"))
    make_multigeo(root, train=2, frames=5, height=24, width=32, voxel_sizes=(8,))
    return root


def _record(store, batch):
    store.append({k: np.array(batch[k]) for k in ("pose", "projection")})


def jax_batches(dataset, sanity, epochs=2):
    """(train, eval) batches the JAX Trainer feeds its steps."""
    task = GenNerfTask(MODEL)
    train, evals = [], []
    task.init_state = lambda key, batch: create_train_state({"params": {"w": jnp.zeros(3)}},
                                                            task.tx)
    task.run_train_step = lambda state, batch, key: (_record(train, batch) or state,
                                                     {"combined": jnp.ones(())})
    task.run_eval_step = lambda state, batch, key: (_record(evals, batch),
                                                    {"combined": jnp.ones(())})[1]

    def no_tail(*a, **k):
        raise RuntimeError("no reconstruction in this test")

    task.reconstruct = no_tail
    out = os.path.join(dataset, f"jax_{sanity}")
    trainer = JTrainer(max_epochs=epochs, devices=1, precision="32-true", log_every_n_steps=1,
                       num_sanity_val_steps=sanity, prefetch_batches=0, save_on_preempt=False,
                       output_dir=out, logger=MetricsLogger(out))
    trainer.fit(task, jdm.ScannetDataModule(dict(DATA, data_dir=dataset), seed=4), seed=4)
    return train, evals


def port_batches(dataset, sanity, monkeypatch, epochs=2):
    """(train, eval) batches the port's Trainer feeds its steps, the train
    CLI's way: the loaders of ScannetDataModule, the trainer settings from
    trainer_options."""
    train, evals = [], []
    monkeypatch.setattr(loop, "train_step", lambda model, opt, batch, gen=None: (
        _record(train, batch), {"combined": torch.ones(())})[1])
    monkeypatch.setattr(loop, "eval_step", lambda model, batch, gen=None: (
        _record(evals, batch), {"combined": torch.ones(())})[1])
    monkeypatch.setattr(loop.Trainer, "_reconstruction_tail",
                        lambda self, batch, mode, step=0: {})
    model = build_model(MODEL, "cpu")
    options = loop.trainer_options({"max_epochs": epochs, "log_every_n_steps": 1,
                                    "num_sanity_val_steps": sanity, "precision": "32-true"})
    opt = make_optimizer(model.parameters(), model.cfg.optimizer, options.pop("gradient_clip_val"))
    mod = tdm.ScannetDataModule(dict(DATA, data_dir=dataset), seed=4)
    trainer = loop.Trainer(model, opt, torch.Generator().manual_seed(4), None, **options)
    trainer.fit(mod.train_dataloader(), mod.val_dataloader())
    return train, evals


def _assert_same(ours, ref, what):
    assert len(ours) == len(ref), (what, len(ours), len(ref))
    for i, (o, r) in enumerate(zip(ours, ref)):
        for k in r:
            np.testing.assert_allclose(o[k], r[k], rtol=0, atol=1e-6, err_msg=f"{what} {i} {k}")


def test_fit_feeds_the_batches_of_the_jax_trainer(dataset, monkeypatch):
    """num_sanity_val_steps 2 and a 2-epoch fit validating every epoch: the
    train batches (after the JAX fit's first-batch pull) and the eval
    batches (the sanity pass's 2, then each validation's) equal the JAX
    Trainer's; without the sanity pass the validation batches differ,
    so the pass is what moves them."""
    ref_train, ref_eval = jax_batches(dataset, 2)
    train, evals = port_batches(dataset, 2, monkeypatch)
    n_val = len(tdm.ScannetDataModule(dict(DATA, data_dir=dataset), seed=4).val_dataloader())
    assert n_val >= 3 and len(ref_eval) == 2 + 2 * n_val
    _assert_same(train, ref_train, "train")
    _assert_same(evals, ref_eval, "eval")
    _, no_sanity = port_batches(dataset, 0, monkeypatch)
    assert len(no_sanity) == 2 * n_val
    assert any(not np.allclose(a["pose"], b["pose"]) for a, b in zip(no_sanity, ref_eval[2:]))


@pytest.mark.parametrize("key,value", [("devices", 2), ("num_slices", 2), ("num_nodes", 2)])
def test_unported_trainer_keys_raise(key, value, monkeypatch):
    """More than one rank is ported (parallel/): the trainer options take
    the key silently, and a process started without a launcher raises,
    naming the key and the launcher."""
    from gennerf_tpu_torch.parallel.platform import select_platform

    for var in ("WORLD_SIZE", "GENNERF_NUM_PROCESSES", "RANK", "GENNERF_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    trainer = {"max_epochs": 1, key: value}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        loop.trainer_options(trainer, {})
    with pytest.raises(RuntimeError, match=f"(?s){key}={value}.*launch_local"):
        select_platform(trainer, "cpu")


@pytest.mark.parametrize("key,value,option", [
    ("limit_train_batches", 2, None), ("limit_val_batches", 0.5, None),
    ("limit_test_batches", 1, None), ("profile_dir", "prof", None),
    ("early_stopping_monitor", "val_combined", None),
    ("callbacks.early_stopping", {"monitor": "val_combined"}, "early_stopping_monitor")])
def test_ported_trainer_keys_pass_through(key, value, option):
    """The harness keys (batch limits, the profiler, early stopping in
    either spelling) reach the Trainer's options silently, and a Trainer
    takes those options."""
    trainer, callbacks = {"max_epochs": 1}, {}
    if key.startswith("callbacks."):
        callbacks[key.split(".", 1)[1]] = value
        value = value["monitor"]
    else:
        trainer[key] = value
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        options = loop.trainer_options(trainer, callbacks)
    assert options[option or key] == value
    options.pop("gradient_clip_val")
    model = build_model(MODEL, "cpu")
    opt = make_optimizer(model.parameters(), model.cfg.optimizer, None)
    trainer = loop.Trainer(model, opt, torch.Generator().manual_seed(0), None, **options)
    assert getattr(trainer, option or key) == value


def test_accepted_keys_and_unknown_ones():
    """The defaults of configs/trainer/default.yaml and
    configs/callbacks/default.yaml, min_epochs without early stopping and
    devices 1 pass silently; an unknown key warns, as the reference's
    Trainer does."""
    cfg = load_experiment_config(os.path.join(REPO, "configs", "experiment",
                                              "seqs_multigeo_4cm.yaml"), "train", [])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        options = loop.trainer_options(dict(cfg["trainer"], min_epochs=50, devices=1),
                                       cfg["callbacks"])
    assert options["num_sanity_val_steps"] == cfg["trainer"]["num_sanity_val_steps"]
    assert set(cfg["callbacks"]) == {"model_checkpoint", "rich_progress_bar", "clear_cache"}
    with pytest.warns(UserWarning, match="swa_lrs"):
        loop.trainer_options({"swa_lrs": 0.1})
    with pytest.warns(UserWarning, match="callbacks.lr_monitor"):
        loop.trainer_options({}, {"lr_monitor": {}})


@pytest.mark.parametrize("name", ["distill_synthetic", "distill_render_synthetic"])
def test_distill_experiments_read_through(name):
    """min_epochs 10 with no early stopping is accepted; the sanity pass is
    off (num_sanity_val_steps 0), validation every 5 of 10 epochs."""
    cfg = load_experiment_config(os.path.join(REPO, "configs", "experiment", name + ".yaml"),
                                 "train", [])
    assert cfg["trainer"]["min_epochs"] == 10
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        options = loop.trainer_options(cfg["trainer"], cfg["callbacks"])
    assert options == {"max_epochs": 10, "min_epochs": 10, "log_every_n_steps": 1,
                       "check_val_every_n_epoch": 5, "num_sanity_val_steps": 0,
                       "precision": "32-true", "gradient_clip_val": None,
                       "limit_train_batches": None, "limit_val_batches": None,
                       "limit_test_batches": None, "profile_dir": None, "profile_steps": 5,
                       "early_stopping_monitor": None, "early_stopping_patience": 3,
                       "early_stopping_mode": "min", "save_on_preempt": True,
                       "model_summary_depth": None, "progress_bar": True, "clear_cache": True,
                       "prefetch_batches": 2}


def test_zero_coverage_warns(monkeypatch):
    """A *_coverage of exactly 0 in an epoch's last row warns that its
    masked term trained on nothing."""
    cover = iter([0.5, 0.0])
    monkeypatch.setattr(loop, "train_step", lambda *a: {
        "combined": torch.tensor(1.0), "distill_coverage": torch.tensor(next(cover))})
    model = build_model(MODEL, "cpu")
    trainer = loop.Trainer(model, make_optimizer(model.parameters(), model.cfg.optimizer, None),
                           torch.Generator().manual_seed(0), None, max_epochs=2,
                           log_every_n_steps=1)
    with pytest.warns(UserWarning, match="distill_coverage == 0 at epoch 1") as record:
        trainer.fit([{}])
    assert len([w for w in record if "coverage" in str(w.message)]) == 1
