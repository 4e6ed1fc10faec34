"""The port's held-out quality drive: the JAX package's offline loop
(write the dataset, train, predict from the best checkpoint, evaluate) run
through the port's command-line entry points, one process each, timed.

    python -m gennerf_tpu_torch.tools.quality_drive --work DIR --summary out.json \\
        [--config configs/experiment/seqs_multigeo_4cm.yaml] [--epochs E] [--device cpu] \\
        [--backbone random:resnet34]

The steps, as a user runs them:
  1. python -m gennerf_tpu_torch.data.make_multigeo --out DIR/data
     (with --backbone, then python -m gennerf_tpu_torch.tools.port_backbone
      SPEC DIR/backbone.npz, grafted by step 2 through
      model.encoder.spatial.pretrained_path=DIR/backbone.npz)
  2. python -m gennerf_tpu_torch.train --config C --data-dir DIR/data --out DIR/run
  3. python -m gennerf_tpu_torch.predict --config C --ckpt DIR/run --data-dir DIR/data
         --split val.txt --out DIR/pred
  4. python -m gennerf_tpu_torch.eval.evaluation --results DIR/pred --dataset val.txt
         --data-dir DIR/data
The summary holds each step's wall seconds, the epochs and seconds per
epoch, the best epoch and its monitored value, the per-scene and mean
metrics, and the card's name and power limit (nvidia-smi). Each step's
output goes to DIR/<step>.log.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
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
    parser.add_argument("--epochs", type=int, help="default: the config's trainer.max_epochs")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--backbone", help="spatial backbone for port_backbone: a torchvision "
                        ".pth or random:<backbone>")
    args = parser.parse_args(argv)

    work = os.path.abspath(args.work)
    os.makedirs(work, exist_ok=True)
    data, run, pred = (os.path.join(work, d) for d in ("data", "run", "pred"))
    config = os.path.abspath(args.config)
    device = ["--device", args.device]
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
    seconds["train"] = run_step(work, "train", "gennerf_tpu_torch.train", train_args)
    seconds["predict"] = run_step(work, "predict", "gennerf_tpu_torch.predict", [
        "--config", config, "--ckpt", run, "--data-dir", data, "--split", "val.txt",
        "--out", pred, *device])
    seconds["evaluate"] = run_step(work, "evaluate", "gennerf_tpu_torch.eval.evaluation", [
        "--results", pred, "--dataset", "val.txt", "--data-dir", data, *device])

    with open(os.path.join(run, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    epochs = 1 + max(int(float(r["epoch"])) for r in rows if r.get("epoch"))
    val = [{k: float(v) for k, v in r.items() if v and k in ("step", "val_combined",
                                                             "val_recon_tsdf_l1")}
           for r in rows if r.get("val_combined")]
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
    summary = {"config": os.path.relpath(config, REPO), "backbone": args.backbone,
               "card": card_line(),
               "seconds": seconds, "wall_s": sum(seconds.values()), "epochs": epochs,
               "train_s_per_epoch": seconds["train"] / epochs, "predict_meta": meta,
               "validations": val, "scenes": scenes, "mean": mean}
    os.makedirs(os.path.dirname(os.path.abspath(args.summary)), exist_ok=True)
    with open(args.summary, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
