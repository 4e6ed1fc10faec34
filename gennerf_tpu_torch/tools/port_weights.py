"""Weights between the reference's PyTorch Lightning checkpoints and the
port's own files (the port's counterpart of scripts/port_weights.py's
gen_nerf mode; numpy and torch only).

    python -m gennerf_tpu_torch.tools.port_weights gen_nerf last.ckpt params.npz \\
        --config configs/experiment/seqs_multigeo_4cm.yaml [--partial] [a.b=value ...]
    python -m gennerf_tpu_torch.tools.port_weights voxel_net last.ckpt port.pt \\
        --config configs/experiment/seqs_multigeo_voxelnet.yaml --partial
    python -m gennerf_tpu_torch.tools.port_weights gen_nerf RUN reference.ckpt \\
        --config configs/experiment/seqs_multigeo_4cm.yaml

The direction follows the output's suffix. Into the port (`.npz` or
`.pt`): the input is a reference `.ckpt` or state-dict `.pth`, read by
utils/port_reference.py into the config's model (strict; `--partial`
leaves the port parameters it lacks at init and prints them), written as a
params npz (the flax tree with `batch_stats/`, as the train CLI's
params.npz) or as a port checkpoint (the model, a fresh optimizer, epoch
0) that `--ckpt` reads. Out of the port (`.ckpt` or `.pth`): the input is
a port checkpoint (a file, or a run or checkpoints/ directory: its best
monitored epoch, else the latest) or a params npz, written as a
reference-named `{"state_dict": ...}`. The mode names the model family and
must match the config's model type. Optimizer states are not converted.
A file conversion: the model is built on the CPU, as tools/port_backbone.py
works in numpy.
"""
from __future__ import annotations

import argparse
import os

MODES = {"gen_nerf": "GenNerf", "voxel_net": "VoxelNet"}


def main(argv=None) -> dict:
    from ..predict import build_model, load_params
    from ..train.checkpoints import load_checkpoint, save_checkpoint, select_checkpoint
    from ..train.state import make_optimizer
    from ..train.tasks import task_for
    from ..utils.config import load_experiment_config
    from ..utils.port_params import save_params_npz
    from ..utils.port_reference import load_reference, weights_format, write_reference

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", choices=sorted(MODES))
    parser.add_argument("input", help="reference .ckpt/.pth, or a port checkpoint, run "
                        "directory or params npz")
    parser.add_argument("output", help=".npz or .pt (into the port), .ckpt or .pth (out of it)")
    parser.add_argument("--config", required=True, help="configs/experiment/<name>.yaml")
    parser.add_argument("--partial", action="store_true",
                        help="leave the port parameters the reference lacks at init")
    parser.add_argument("overrides", nargs="*", help="config overrides a.b.c=value")
    args = parser.parse_args(argv)

    cfg = load_experiment_config(args.config, "predict", args.overrides)
    kind = cfg["model"].get("type", "GenNerf")
    if kind != MODES[args.mode]:
        raise SystemExit(f"mode {args.mode} needs a {MODES[args.mode]} config, not {kind}")
    model = build_model(cfg["model"], "cpu")
    suffix = os.path.splitext(args.output)[1]
    record = {"mode": args.mode, "input": args.input, "output": args.output}
    if suffix in (".npz", ".pt"):
        ported = load_reference(model, args.input, args.partial)
        record.update(left_at_init=ported.unfilled, unused=ported.unused)
        if suffix == ".npz":
            save_params_npz(args.output, task_for(model).npz_tree(model.state_dict()))
        else:
            save_checkpoint(args.output, model, make_optimizer(model.parameters(),
                                                               model.cfg.optimizer), 0, 0)
    elif suffix in (".ckpt", ".pth"):
        if os.path.isfile(args.input) and weights_format(args.input) == "npz":
            load_params(model, args.input)
        else:
            path, _ = select_checkpoint(args.input)
            load_checkpoint(path, model)
            record["input"] = path
        write_reference(model, args.output)
    else:
        raise SystemExit(f"unknown output suffix {suffix!r}: .npz or .pt into the port, "
                         ".ckpt or .pth out of it")
    n_values = sum(int(v.numel()) for v in model.state_dict().values())
    print(f"wrote {args.output}: {len(model.state_dict())} tensors, {n_values:,} values",
          flush=True)
    return record


if __name__ == "__main__":
    main()
