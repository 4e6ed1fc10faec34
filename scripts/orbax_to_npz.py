#!/usr/bin/env python3
"""Convert a JAX training run's orbax checkpoint into a params npz that the
PyTorch port reads (`--params` of gennerf_tpu_torch's train, predict and
render CLIs; gennerf_tpu_torch.utils.port_params.load_params_npz).

    python scripts/orbax_to_npz.py RUN_DIR out/params.npz [--epoch E]

RUN_DIR is the run's checkpoint directory, or its output directory holding
`checkpoints/`. It is opened through gennerf_tpu.train.checkpoints.
CheckpointManager with the run's own checkpoint rule (callbacks.
model_checkpoint of its config.json snapshot) and only read. The epoch is
`--epoch`, else the best monitored epoch, else the latest: the rule of
the port's select_checkpoint and of scripts/predict.py. The TrainState is
restored without a template, as plain dicts of arrays; its `params` go to
the npz's root and its `batch_stats` (VoxelNet's and the spatial
encoder's running statistics) under `batch_stats/`, '/'-joined keys. The
optimizer state is not written. The run's config.json is copied beside
the npz. Needs JAX and orbax; the port itself never imports them.
"""
import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def checkpoint_dir(path: str) -> str:
    """The checkpoint directory of a run (its `checkpoints/`) or the path itself."""
    nested = os.path.join(path, "checkpoints")
    return nested if os.path.isdir(nested) else path


def flatten(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v, np.float32)
    return out


def convert(run: str, output: str, epoch=None) -> dict:
    """Write the npz (and config.json beside it); returns what was chosen:
    the epoch, how (`--epoch`, the monitor, or 'latest') and the counts."""
    from gennerf_tpu.train.checkpoints import CheckpointManager

    directory = checkpoint_dir(os.path.abspath(run))
    config_path = os.path.join(directory, "config.json")
    config = {}
    if os.path.isfile(config_path):
        with open(config_path) as f:
            config = json.load(f)
    ckpt_cfg = (config.get("callbacks") or {}).get("model_checkpoint") or {}
    mgr = CheckpointManager(directory, save_top_k=ckpt_cfg.get("save_top_k", -1),
                            monitor=ckpt_cfg.get("monitor"), mode=ckpt_cfg.get("mode", "min"))
    try:
        if epoch is not None:
            selected_by = "--epoch"
        else:
            epoch = mgr.best_epoch()
            selected_by = ckpt_cfg.get("monitor") if epoch is not None else "latest"
            if epoch is None:
                epoch = mgr.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
        state = mgr.restore(None, int(epoch))  # no template: plain dicts of arrays
    finally:
        mgr.close()
    params = flatten(dict(state["params"]))
    stats = flatten(dict(state.get("batch_stats") or {}), "batch_stats")
    os.makedirs(os.path.dirname(os.path.abspath(output)) or ".", exist_ok=True)
    np.savez(output, **params, **stats)
    if os.path.isfile(config_path):
        shutil.copyfile(config_path, os.path.join(os.path.dirname(os.path.abspath(output)),
                                                  "config.json"))
    return {"epoch": int(epoch), "selected_by": selected_by, "params": len(params),
            "batch_stats": len(stats)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("run", help="a JAX run's checkpoint directory, or its output directory")
    parser.add_argument("output", help="npz to write")
    parser.add_argument("--epoch", type=int, help="epoch to convert (default: best, else latest)")
    args = parser.parse_args(argv)
    record = convert(args.run, args.output, args.epoch)
    print(f"wrote {args.output}: epoch {record['epoch']} ({record['selected_by']}), "
          f"{record['params']} params arrays, {record['batch_stats']} batch_stats arrays")
    return record


if __name__ == "__main__":
    main()
