"""Train the GenNerf of an experiment config (counterpart of the
reference's scripts/train.py for GenNerf experiments).

    python -m gennerf_tpu_torch.train --config configs/experiment/seqs_multigeo_4cm.yaml \
        --out runs/multigeo [--data-dir D | --batch b.npz | --synthetic] [--params p.npz] \
        [--epochs E] [--resume dir] [--seed S] [--device cpu] [key.path=value ...]
    python -m gennerf_tpu_torch.train --config configs/experiment/seqs_multigeo_spatial.yaml \
        --out runs/spatial --data-dir D model.encoder.spatial.pretrained_path=backbone.npz

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

`--params` starts from a JAX params npz (utils/port_params.py), `--resume`
continues a run from its checkpoint directory. The trainer settings
(max_epochs, log_every_n_steps, check_val_every_n_epoch,
gradient_clip_val) come from the config's `trainer`, the checkpoint rule
(dirpath, monitor, mode, save_top_k, save_last) from
`callbacks.model_checkpoint`, with paths.output_dir set to `--out`. It
writes out/metrics.csv, the checkpoints (out/checkpoints/ by default; the
predict and render CLIs' `--ckpt` pick the best monitored epoch there),
out/local/ (the validation tail's volumes and meshes) and out/params.npz
(the last epoch's model as a params tree, with the spatial encoder's
BatchNorm running statistics under batch_stats/). When the config sets
`test: true`, the best monitored epoch (else the last) then runs the test pass
with its reconstruction tail. Runs on the card unless `--device cpu` is
given, and raises when there is none.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.datamodule import ScannetDataModule
from ..data.synthetic import training_batch
from ..device import resolve_device, set_reference_precision
from ..predict import build_model
from ..utils.config import load_experiment_config
from ..utils.port_params import (
    gen_nerf_npz_tree, gen_nerf_params_from_flax, load_params_npz, save_params_npz,
)
from .checkpoints import CheckpointManager
from .loop import Trainer
from .state import make_optimizer

# the frames of the repo's multigeo dataset (data/make_multigeo.py)
HEIGHT, WIDTH = 120, 160
AUGMENTATION_KEYS = ("random_rotation_3d", "random_translation_3d")


def fixed_batches(args, data_cfg: dict, model_cfg):
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
                            args.seed)],
            [training_batch(B, int(data_cfg["num_frames_val"]), HEIGHT, WIDTH, dims, vs,
                            args.seed + 1)])


def main(argv=None) -> Trainer:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True, help="configs/experiment/<name>.yaml")
    parser.add_argument("--out", required=True, help="output directory")
    source = parser.add_mutually_exclusive_group()
    source.add_argument("--data-dir", help="dataset root (overrides paths.data_dir)")
    source.add_argument("--batch", help="npz of one training batch")
    source.add_argument("--synthetic", action="store_true",
                        help="one synthetic batch built from the seed")
    parser.add_argument("--params", help="npz of a JAX params tree to start from")
    parser.add_argument("--epochs", type=int, help="max epochs (default: trainer.max_epochs)")
    parser.add_argument("--resume", help="checkpoint, or directory of an earlier run")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*", help="config overrides a.b.c=value")
    args = parser.parse_args(argv)

    overrides = [f"paths.output_dir={os.path.abspath(args.out)}"]
    if args.data_dir:
        overrides.append(f"paths.data_dir={os.path.abspath(args.data_dir)}")
    overrides += args.overrides
    cfg = load_experiment_config(args.config, "train", overrides)
    trainer_cfg, data_cfg = cfg["trainer"], cfg["data"]
    if str(trainer_cfg.get("precision", "32-true")) not in ("32-true", "32"):
        raise NotImplementedError(
            f"trainer.precision {trainer_cfg['precision']!r}: the port trains in float32 only")
    device = resolve_device(args.device)
    set_reference_precision()
    model = build_model(cfg["model"], device, args.seed)
    if args.params:
        model.load_state_dict(gen_nerf_params_from_flax(load_params_npz(args.params)))
    optimizer = make_optimizer(model.parameters(), model.cfg.optimizer,
                               trainer_cfg.get("gradient_clip_val"))
    if args.batch or args.synthetic:
        train_data, val_data = fixed_batches(args, data_cfg, model.cfg)
        test_data = val_data
    else:
        datamodule = ScannetDataModule(data_cfg, seed=args.seed)
        train_data, val_data = datamodule.train_dataloader(), datamodule.val_dataloader()
        test_data = datamodule.test_dataloader() if cfg.get("test") else None
    ckpt_cfg = (cfg.get("callbacks") or {}).get("model_checkpoint") or {}
    checkpoints = CheckpointManager(
        ckpt_cfg.get("dirpath") or os.path.join(args.out, "checkpoints"),
        save_top_k=int(ckpt_cfg.get("save_top_k", -1)),
        save_last=bool(ckpt_cfg.get("save_last", True)),
        monitor=ckpt_cfg.get("monitor"), mode=ckpt_cfg.get("mode", "min"))
    trainer = Trainer(
        model, optimizer, torch.Generator(device=device).manual_seed(args.seed), args.out,
        max_epochs=args.epochs or int(trainer_cfg["max_epochs"]),
        log_every_n_steps=int(trainer_cfg.get("log_every_n_steps", 50)),
        check_val_every_n_epoch=int(trainer_cfg.get("check_val_every_n_epoch", 1)),
        checkpoints=checkpoints)
    metrics = trainer.fit(train_data, val_data, ckpt_path=args.resume)
    save_params_npz(os.path.join(args.out, "params.npz"), gen_nerf_npz_tree(model.state_dict()))
    print(f"trained {trainer.global_step} steps: "
          + ", ".join(f"{k}={v:.5g}" for k, v in sorted(metrics.items())))
    if cfg.get("test"):
        best = checkpoints.best_epoch()
        if best is not None:
            checkpoints.restore_best(model)
        metrics = trainer.test(test_data)
        label = f"epoch {best}, best {checkpoints.monitor}" if best is not None else "last epoch"
        print(f"test ({label}): " + ", ".join(f"{k}={v:.5g}" for k, v in sorted(metrics.items())))
    return trainer


if __name__ == "__main__":
    main()
