"""Train the model of an experiment config, GenNerf or VoxelNet (counterpart
of the reference's scripts/train.py).

    python -m gennerf_tpu_torch.train --config configs/experiment/seqs_multigeo_4cm.yaml \
        --out runs/multigeo [--data-dir D | --batch b.npz | --synthetic] [--params p.npz] \
        [--epochs E] [--resume dir] [--seed S] [--device cpu] [key.path=value ...]
    python -m gennerf_tpu_torch.train --config configs/experiment/seqs_multigeo_spatial.yaml \
        --out runs/spatial --data-dir D model.encoder.spatial.pretrained_path=backbone.npz
    python -m gennerf_tpu_torch.train --config configs/experiment/seqs_multigeo_voxelnet.yaml \
        --out runs/voxelnet --data-dir D [trainer.precision=32-true]
    python -m gennerf_tpu_torch.train \
        --config configs/experiment/seq1_frames8_evenspaced_pointnet.yaml --out runs/flagship \
        --data-dir D data.datasets_train=[train.txt] data.datasets_val=[val.txt] \
        data.datasets_test=[val.txt] data.sequence_length=10 ...  (README: the whole line)
    python -m gennerf_tpu_torch.train --config configs/experiment/seqs_multigeo_4cm.yaml \
        --out sweeps/grid --data-dir D hparams_search=gen_nerf_grid

Trailing `a.b.c=value` arguments override the composed config, as the
reference's command line does (above: the backbone npz of
tools/port_backbone.py grafted into the spatial encoder at init).

By default it trains on the config's dataset: `ScannetDataModule` builds
the train and validation loaders from the `data` keys (the dataset lists,
the sequence windowing, workers, shuffling and the 3D augmentation), with
the data directory `--data-dir` (else `paths.data_dir`). Two fixed
batches remain as explicit choices: `--batch`, an npz with a batch's keys,
which then also serves validation, and `--synthetic`,
`data.synthetic.training_batch` from the seed (data.batch_size scenes of
data.num_frames_train frames of 120x160, the ground truth fused at
voxel_dim_train), validated on one more scene from seed + 1. Neither
augments, so both raise NotImplementedError when the config asks for
random_rotation_3d or random_translation_3d.

`--params` starts from a JAX params npz (utils/port_params.py;
scripts/orbax_to_npz.py converts a JAX run) or a reference Lightning
`.ckpt` / `.pth` (utils/port_reference.py, as in the predict CLI),
`--resume` continues a run from its checkpoint directory (a
reference `.ckpt`'s optimizer state is not ported: resuming one raises
NotImplementedError). The trainer settings come
from the config's `trainer` and `callbacks` groups
(`train.loop.trainer_options`: every key is ported, accepted or raises
NotImplementedError; early stopping from callbacks.early_stopping, the
trainer's early_stopping_* winning; the batch limits, the profiler window,
the SIGTERM save, the parameter table, the progress line and clear_cache),
the checkpoint rule (dirpath, monitor, mode, save_top_k, save_last) from
`callbacks.model_checkpoint`, with paths.output_dir set to `--out`.

Every root key of the composed config is read (an unknown one warns):
- `seed`: the run seed is `--seed` when given, else `seed` (null: 0); it
  seeds the model's initialisation, the loaders and the step generator;
- `ckpt_path`: resume from it, as `--resume` does (both given and
  different: ValueError);
- `train: false`: no fit; the weights are restored from `ckpt_path` (else
  `--resume`, else out/checkpoints), the latest epoch, and only the test
  pass runs;
- `test: true`: after the fit, the best monitored epoch (else the last)
  runs the test pass with its reconstruction tail;
- `logger`: the backends of the MetricsLogger (train/loggers.py);
- `extras`, `tags`: before anything else the warnings filter, the tags
  (tags.log) and the config tree (config_tree.log) into `--out`; the
  legacy root `print_config: false` silences the tree;
- `task_name`, `tags`, `seed`, `ckpt_path` go to the loggers with the
  model, data, trainer, callbacks and extras subtrees and the parameter
  counts (`log_hyperparameters`);
- `hparams_search` (the group choice `hparams_search=<name>`): the whole
  run goes to the sweep runner (train/sweep.py) over that group's
  parameters, one trial of this command per point in `--out`/trial_XXX;
  `main` then returns the sweep's records.

It writes out/metrics.csv (the trainer's rows with the step timings), the
logger group's files (out/csv/, out/tensorboard/), the checkpoints
(out/checkpoints/ by default; the predict and render CLIs' `--ckpt` pick
the best monitored epoch there), out/local/ (the validation tail's
volumes, meshes and comparison renders) and out/params.npz (the last
epoch's model as a params tree, with the BatchNorm running statistics
under batch_stats/). The model computes in trainer.precision's dtype
(train/tasks.py): float32 under '32-true', bfloat16 under 'bf16-mixed' /
'16-mixed' (either family). On SIGTERM (trainer.save_on_preempt, on by
default) the run saves the current epoch at the next step boundary and
exits 0 without the test pass; `--resume out` continues at the next
epoch. Runs on the card unless `--device cpu` is given, and raises when
there is none.
"""
from __future__ import annotations

import argparse
import os
import sys
import warnings

import numpy as np
import torch

from ..data.datamodule import ScannetDataModule
from ..data.synthetic import training_batch
from ..device import resolve_device, set_reference_precision
from ..predict import build_model, load_params
from ..utils.config import load_experiment_config
from ..utils.port_params import save_params_npz
from ..utils.console import extras
from .checkpoints import CheckpointManager, load_checkpoint, resolve_checkpoint
from .loggers import MetricsLogger
from .loop import Trainer, trainer_options
from .state import make_optimizer
from .tasks import task_for

# the frames of the repo's multigeo dataset (data/make_multigeo.py)
HEIGHT, WIDTH = 120, 160
AUGMENTATION_KEYS = ("random_rotation_3d", "random_translation_3d")
# the root keys of configs/train.yaml and its groups; print_config is the
# legacy switch of the config tree
ROOT_KEYS = ("data", "model", "callbacks", "logger", "trainer", "paths", "extras", "task_name",
             "tags", "train", "test", "ckpt_path", "seed", "hparams_search", "print_config")


def fixed_batches(args, data_cfg: dict, model_cfg, seed: int):
    """The train and validation batches of `--batch` or `--synthetic`;
    raises NotImplementedError when the config asks for augmentation,
    which needs the loaders."""
    asked = [k for k in AUGMENTATION_KEYS if data_cfg.get(k)]
    if asked:
        raise NotImplementedError(
            f"data.{', data.'.join(asked)} augment through the loaders; train from the dataset "
            "(--data-dir) or turn them off for --batch / --synthetic")
    if args.batch:
        with np.load(args.batch) as f:
            train = [{k: f[k] for k in f.files}]
        return train, train
    B = int(data_cfg["batch_size"])
    dims, vs = model_cfg.voxel_dim_train, model_cfg.voxel_size
    return ([training_batch(B, int(data_cfg["num_frames_train"]), HEIGHT, WIDTH, dims, vs,
                            seed)],
            [training_batch(B, int(data_cfg["num_frames_val"]), HEIGHT, WIDTH, dims, vs,
                            seed + 1)])


def _sweep_arguments(argv) -> list:
    """The command line of one sweep trial: this one without `--out` and
    the hparams_search choice (the sweep gives each trial its directory
    and turns the search off)."""
    out, skip = [], False
    for token in argv:
        if skip:
            skip = False
        elif token == "--out":
            skip = True
        elif not token.startswith(("--out=", "hparams_search=")):
            out.append(token)
    return out + ["hparams_search=null"]


def main(argv=None):
    """Train (and test) as the config asks; returns the Trainer, or under
    `hparams_search` the sweep's records."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True, help="configs/experiment/<name>.yaml")
    parser.add_argument("--out", required=True, help="output directory")
    source = parser.add_mutually_exclusive_group()
    source.add_argument("--data-dir", help="dataset root (overrides paths.data_dir)")
    source.add_argument("--batch", help="npz of one training batch")
    source.add_argument("--synthetic", action="store_true",
                        help="one synthetic batch built from the seed")
    parser.add_argument("--params", help="npz of a JAX params tree, or a reference Lightning "
                        ".ckpt or state-dict .pth, to start from")
    parser.add_argument("--epochs", type=int, help="max epochs (default: trainer.max_epochs)")
    parser.add_argument("--resume", help="checkpoint, or directory of an earlier run")
    parser.add_argument("--seed", type=int, help="run seed (default: the config's seed, else 0)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*", help="config overrides a.b.c=value")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)

    overrides = [f"paths.output_dir={os.path.abspath(args.out)}"]
    if args.data_dir:
        overrides.append(f"paths.data_dir={os.path.abspath(args.data_dir)}")
    overrides += args.overrides
    cfg = load_experiment_config(args.config, "train", overrides)
    unknown = sorted(set(cfg) - set(ROOT_KEYS))
    if unknown:
        warnings.warn(f"ignoring unknown root config key(s): {unknown}")
    if cfg.get("hparams_search"):
        from .sweep import main as sweep_main

        return sweep_main(["--output", args.out, "--", *_sweep_arguments(argv)],
                          spec=cfg["hparams_search"])
    if cfg.get("print_config") is False and cfg.get("extras"):
        cfg["extras"] = dict(cfg["extras"], print_config=False)
    extras(cfg)
    seed = args.seed if args.seed is not None else int(cfg.get("seed") or 0)
    if args.resume and cfg.get("ckpt_path") and (
            os.path.abspath(args.resume) != os.path.abspath(cfg["ckpt_path"])):
        raise ValueError(f"--resume {args.resume} and ckpt_path={cfg['ckpt_path']} differ")
    resume = args.resume or cfg.get("ckpt_path")

    data_cfg = cfg["data"]
    options = trainer_options(cfg.get("trainer"), cfg.get("callbacks"))
    device = resolve_device(args.device)
    set_reference_precision()
    model = build_model(cfg["model"], device, seed, str(options["precision"]))
    task = task_for(model)
    if args.params:
        load_params(model, args.params)
    optimizer = make_optimizer(model.parameters(), model.cfg.optimizer,
                               options.pop("gradient_clip_val"))
    if args.batch or args.synthetic:
        train_data, val_data = fixed_batches(args, data_cfg, model.cfg, seed)
        test_data = val_data
    else:
        datamodule = ScannetDataModule(data_cfg, seed=seed)
        train_data, val_data = datamodule.train_dataloader(), datamodule.val_dataloader()
        test_data = datamodule.test_dataloader() if cfg.get("test") else None
    ckpt_cfg = (cfg.get("callbacks") or {}).get("model_checkpoint") or {}
    checkpoints = CheckpointManager(
        ckpt_cfg.get("dirpath") or os.path.join(args.out, "checkpoints"),
        save_top_k=int(ckpt_cfg.get("save_top_k", -1)),
        save_last=bool(ckpt_cfg.get("save_last", True)),
        monitor=ckpt_cfg.get("monitor"), mode=ckpt_cfg.get("mode", "min"))
    if args.epochs:
        options["max_epochs"] = args.epochs
    trainer = Trainer(model, optimizer, torch.Generator(device=device).manual_seed(seed),
                      args.out, checkpoints=checkpoints,
                      logger=MetricsLogger(args.out, cfg.get("logger")), **options)
    trained = cfg.get("train", True)
    if trained:
        metrics = trainer.fit(train_data, val_data, ckpt_path=resume, config_snapshot=cfg)
        if trainer.preempted:
            print(f"preempted at step {trainer.global_step}: resume with --resume {args.out}")
            return trainer
        save_params_npz(os.path.join(args.out, "params.npz"), task.npz_tree(model.state_dict()))
        print(f"trained {trainer.global_step} steps: "
              + ", ".join(f"{k}={v:.5g}" for k, v in sorted(metrics.items())))
    else:
        path = resolve_checkpoint(resume or checkpoints.directory)
        trainer.global_step = load_checkpoint(path, model)["step"]
        print(f"train: false, restored {path}")
    if cfg.get("test"):
        best = checkpoints.best_epoch() if trained else None
        if best is not None:
            checkpoints.restore_best(model)
        metrics = trainer.test(test_data)
        label = (f"epoch {best}, best {checkpoints.monitor}" if best is not None
                 else "last epoch" if trained else "restored checkpoint")
        print(f"test ({label}): " + ", ".join(f"{k}={v:.5g}" for k, v in sorted(metrics.items())))
    return trainer


if __name__ == "__main__":
    main()
