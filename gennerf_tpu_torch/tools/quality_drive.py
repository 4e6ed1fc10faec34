"""The port's held-out quality drive: the JAX package's offline loop
(write the dataset, train, predict from the best checkpoint, evaluate) run
through the port's command-line entry points, one process each, timed.

    python -m gennerf_tpu_torch.tools.quality_drive --work DIR --summary out.json \\
        [--config configs/experiment/seqs_multigeo_4cm.yaml] [--epochs E] [--device cpu] \\
        [--backbone random:resnet34] [key.path=value ...]
    python -m gennerf_tpu_torch.tools.quality_drive --work DIR --summary out.json \\
        --config configs/experiment/seqs_multigeo_voxelnet.yaml [trainer.precision=32-true]
    python -m gennerf_tpu_torch.tools.quality_drive --work DIR --summary out.json \\
        --config configs/experiment/seqs_multigeo_4cm.yaml trainer.precision=bf16-mixed
    python -m gennerf_tpu_torch.tools.quality_drive --work DIR --summary out.json \\
        --scene synth0 --config configs/experiment/distill_render_synthetic.yaml --epochs 60

The steps, as a user runs them:
  1. python -m gennerf_tpu_torch.data.make_multigeo --out DIR/data
     (with --scene synth0: python -m gennerf_tpu_torch.data.synthetic --out
      DIR/data, the distillation experiments' one scene, which they train
      and validate on; DIR/data/val.txt then lists it, so steps 3 and 4
      score the training scene)
     (with --backbone, then python -m gennerf_tpu_torch.tools.port_backbone
      SPEC DIR/backbone.npz, grafted by step 2 through
      model.encoder.spatial.pretrained_path=DIR/backbone.npz)
  2. python -m gennerf_tpu_torch.train --config C --data-dir DIR/data --out DIR/run [key=value]
  3. python -m gennerf_tpu_torch.predict --config C --ckpt DIR/run --data-dir DIR/data
         --split val.txt --out DIR/pred [key=value]
  4. python -m gennerf_tpu_torch.eval.evaluation --results DIR/pred --dataset val.txt
         --data-dir DIR/data
Trailing `key=value` overrides go to both the train and the predict CLI
(a VoxelNet control in float32: trainer.precision=32-true; the pointnet
drive in bf16-mixed: trainer.precision=bf16-mixed). The summary
holds each step's wall seconds, the epochs and seconds per epoch, the
median step and loader wait (metrics.csv), the validations (every val_*
column), the per-epoch trajectory of the logged train_* columns (the
last row of each epoch: train_distill, train_distill_coverage and
train_render_hit_rate under distillation), the predict record (the best
epoch, how it was selected, the precision), the per-scene and mean
metrics, and the card's name and power limit (nvidia-smi). Each step's
output goes to DIR/<step>.log.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CONFIG = os.path.join(REPO, "configs", "experiment", "seqs_multigeo_4cm.yaml")


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except FileNotFoundError:
        return "no nvidia-smi"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "no card"


def run_step(work: str, name: str, module: str, args) -> float:
    """Run `python -m module args` from the repo root with its output in
    work/name.log; returns its wall seconds, raises when it fails."""
    log = os.path.join(work, f"{name}.log")
    t0 = time.perf_counter()
    with open(log, "w") as f:
        rc = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO, stdout=f,
                            stderr=subprocess.STDOUT).returncode
    seconds = time.perf_counter() - t0
    if rc != 0:
        with open(log) as f:
            tail = f.read()[-4000:]
        raise RuntimeError(f"{name} failed with code {rc}:\n{tail}")
    print(f"{name}: {seconds:.1f} s", flush=True)
    return seconds


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--work", required=True, help="directory for the data, run and results")
    parser.add_argument("--summary", required=True, help="path of the summary JSON")
    parser.add_argument("--config", default=DEFAULT_CONFIG)
    parser.add_argument("--scene", choices=("multigeo", "synth0"), default="multigeo",
                        help="the dataset step 1 writes")
    parser.add_argument("--epochs", type=int, help="default: the config's trainer.max_epochs")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--backbone", help="spatial backbone for port_backbone: a torchvision "
                        ".pth or random:<backbone>")
    parser.add_argument("overrides", nargs="*", help="config overrides a.b.c=value")
    args = parser.parse_args(argv)

    work = os.path.abspath(args.work)
    os.makedirs(work, exist_ok=True)
    data, run, pred = (os.path.join(work, d) for d in ("data", "run", "pred"))
    config = os.path.abspath(args.config)
    device = ["--device", args.device]
    if args.scene == "synth0":
        seconds = {"dataset": run_step(work, "dataset", "gennerf_tpu_torch.data.synthetic",
                                       ["--out", data])}
        with open(os.path.join(data, "val.txt"), "w") as f:
            f.write("scans/scene_synth0/info.json\n")
    else:
        seconds = {"dataset": run_step(work, "dataset", "gennerf_tpu_torch.data.make_multigeo",
                                       ["--out", data])}
    train_args = ["--config", config, "--data-dir", data, "--out", run, *device]
    if args.epochs:
        train_args += ["--epochs", str(args.epochs)]
    if args.backbone:
        backbone = os.path.join(work, "backbone.npz")
        seconds["backbone"] = run_step(work, "backbone", "gennerf_tpu_torch.tools.port_backbone",
                                       [args.backbone, backbone])
        train_args.append(f"model.encoder.spatial.pretrained_path={backbone}")
    seconds["train"] = run_step(work, "train", "gennerf_tpu_torch.train",
                                train_args + args.overrides)
    seconds["predict"] = run_step(work, "predict", "gennerf_tpu_torch.predict", [
        "--config", config, "--ckpt", run, "--data-dir", data, "--split", "val.txt",
        "--out", pred, *device, *args.overrides])
    seconds["evaluate"] = run_step(work, "evaluate", "gennerf_tpu_torch.eval.evaluation", [
        "--results", pred, "--dataset", "val.txt", "--data-dir", data, *device])

    with open(os.path.join(run, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    epochs = 1 + max(int(float(r["epoch"])) for r in rows if r.get("epoch"))
    val = [{k: float(v) for k, v in r.items() if v and (k == "step" or k.startswith("val_"))}
           for r in rows if any(v and k.startswith("val_") for k, v in r.items())]
    trajectory = {}
    for r in rows:  # an epoch's last train row
        if r.get("epoch") and r.get("step_ms"):
            trajectory[int(float(r["epoch"]))] = {
                k: float(v) for k, v in r.items() if v and k.startswith("train_")}
    steps = [float(r["step_ms"]) for r in rows if r.get("step_ms")]
    waits = [float(r["data_wait_ms"]) for r in rows if r.get("data_wait_ms")]
    with open(os.path.join(pred, "predict_meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(pred, "metrics_mean.json")) as f:
        mean = json.load(f)
    scenes = {}
    for name in sorted(os.listdir(pred)):
        if name.endswith("_metrics.json"):
            with open(os.path.join(pred, name)) as f:
                m = json.load(f)
            scenes[m["scene"]] = m
    summary = {"config": os.path.relpath(config, REPO), "scene": args.scene,
               "backbone": args.backbone,
               "overrides": args.overrides, "card": card_line(),
               "seconds": seconds, "wall_s": sum(seconds.values()), "epochs": epochs,
               "train_s_per_epoch": seconds["train"] / epochs,
               "step_ms_median_logged": statistics.median(steps) if steps else None,
               "data_wait_ms_median_logged": statistics.median(waits) if waits else None,
               "predict_meta": meta,
               "validations": val, "trajectory": [trajectory[e] for e in sorted(trajectory)],
               "scenes": scenes, "mean": mean}
    os.makedirs(os.path.dirname(os.path.abspath(args.summary)), exist_ok=True)
    with open(args.summary, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
