"""Train the pointnet-only GenNerf of an experiment config (counterpart of
the reference's scripts/train.py for GenNerf experiments).

    python -m gennerf_tpu_torch.train --config configs/experiment/seqs_multigeo_4cm.yaml \
        --out runs/multigeo [--batch b.npz] [--params p.npz] [--epochs E] \
        [--resume dir] [--seed S] [--device cpu]

Without `--batch` it trains on `data.synthetic.training_batch` built from
the seed (data.batch_size scenes of data.num_frames_train frames of
120x160, the repo's multigeo dataset frames, the ground truth fused at
voxel_dim_train) and validates on one more scene from seed + 1; `--batch`
is an npz with that batch's keys, which then also serves validation.
`--params` starts from a JAX params npz (utils/port_params.py), `--resume`
continues a run from its checkpoint directory. The trainer settings
(max_epochs, log_every_n_steps, check_val_every_n_epoch,
gradient_clip_val) come from the config's `trainer`. It writes
out/metrics.csv, out/checkpoints/ and out/params.npz (the trained model
as a params tree, which the predict and render CLIs read). Runs on the
card unless `--device cpu` is given, and raises when there is none.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.synthetic import training_batch
from ..device import resolve_device, set_reference_precision
from ..predict import build_model
from ..utils.config import load_experiment_config
from ..utils.port_params import (
    flax_params_from_gen_nerf, gen_nerf_params_from_flax, load_params_npz, save_params_npz,
)
from .loop import Trainer
from .state import make_optimizer

# the frames of the repo's multigeo dataset (scripts/local/make_multigeo_dataset.py)
HEIGHT, WIDTH = 120, 160


def main(argv=None) -> Trainer:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True, help="configs/experiment/<name>.yaml")
    parser.add_argument("--out", required=True, help="output directory")
    parser.add_argument("--batch", help="npz of a training batch (default: synthetic scenes)")
    parser.add_argument("--params", help="npz of a JAX params tree to start from")
    parser.add_argument("--epochs", type=int, help="max epochs (default: trainer.max_epochs)")
    parser.add_argument("--resume", help="checkpoint, or directory of an earlier run")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    cfg = load_experiment_config(args.config, "train")
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
    if args.batch:
        with np.load(args.batch) as f:
            train_batches = [{k: f[k] for k in f.files}]
        val_batches = train_batches
    else:
        B = int(data_cfg["batch_size"])
        dims, vs = model.cfg.voxel_dim_train, model.cfg.voxel_size
        train_batches = [training_batch(B, int(data_cfg["num_frames_train"]), HEIGHT, WIDTH,
                                        dims, vs, args.seed)]
        val_batches = [training_batch(B, int(data_cfg["num_frames_val"]), HEIGHT, WIDTH,
                                      dims, vs, args.seed + 1)]
    trainer = Trainer(
        model, optimizer, torch.Generator(device=device).manual_seed(args.seed), args.out,
        max_epochs=args.epochs or int(trainer_cfg["max_epochs"]),
        log_every_n_steps=int(trainer_cfg.get("log_every_n_steps", 50)),
        check_val_every_n_epoch=int(trainer_cfg.get("check_val_every_n_epoch", 1)))
    metrics = trainer.fit(train_batches, val_batches, ckpt_path=args.resume)
    save_params_npz(os.path.join(args.out, "params.npz"), flax_params_from_gen_nerf(model.state_dict()))
    print(f"trained {trainer.global_step} steps: "
          + ", ".join(f"{k}={v:.5g}" for k, v in sorted(metrics.items())))
    return trainer


if __name__ == "__main__":
    main()
