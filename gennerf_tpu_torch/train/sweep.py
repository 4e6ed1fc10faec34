"""Hyperparameter sweeps over the port's train CLI (counterpart of the
reference's scripts/sweep.py).

    python -m gennerf_tpu_torch.train.sweep --config configs/hparams_search/gen_nerf_grid.yaml \
        --output sweeps/lr [--seed S] -- --config configs/experiment/seqs_multigeo_4cm.yaml \
        --data-dir D [--device cpu] [key.path=value ...]

The sweep yaml (configs/hparams_search/*.yaml, configs/sweeps/*.yaml)
names dotted parameters with a list of values (`{values: [...]}`) or,
under `method: random`, a range (`{min, max, log}`); `count` trials for
random search; `metric` ranks the trials (lower is better;
val_combined by default); `command_overrides` go to every trial. The
arguments after `--` are the train CLI's (gennerf_tpu_torch.train), given
to every trial with its own `--out` <output>/trial_XXX and its point's
`key=value` overrides. Each trial's record (its parameters and last
metrics, or its error) is appended to <output>/sweep_results.jsonl as it
ends; a failing trial does not stop the sweep. The train CLI hands a run
to `main` when its config has an `hparams_search` group.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
from typing import Dict, Iterator, List, Optional

import numpy as np
import yaml


def trial_overrides(sweep_cfg: dict, rng: np.random.Generator) -> Iterator[Dict]:
    """The sweep's points: the grid's product in order, or `count` random
    draws from `rng` (a value list draws an index, a range a uniform value,
    in log space under `log`)."""
    params = sweep_cfg.get("parameters", {})
    if sweep_cfg.get("method", "grid") == "grid":
        keys = list(params)
        for combo in itertools.product(*[params[k]["values"] for k in keys]):
            yield dict(zip(keys, combo))
        return
    for _ in range(int(sweep_cfg.get("count", 10))):
        trial = {}
        for k, spec in params.items():
            if "values" in spec:
                trial[k] = spec["values"][rng.integers(len(spec["values"]))]
            else:
                lo, hi = float(spec["min"]), float(spec["max"])
                if spec.get("log", False):
                    trial[k] = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
                else:
                    trial[k] = float(rng.uniform(lo, hi))
        yield trial


def main(argv: Optional[List[str]] = None, spec: Optional[dict] = None) -> List[dict]:
    """Run every trial; returns their records in order. `spec`: the sweep
    config itself (the train CLI's hparams_search group), else --config."""
    argv = list(argv or [])
    train_args: List[str] = []
    if "--" in argv:
        cut = argv.index("--")
        argv, train_args = argv[:cut], argv[cut + 1:]
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=spec is None, help="the sweep yaml")
    parser.add_argument("--output", required=True, help="the sweep's directory")
    parser.add_argument("--seed", type=int, default=0, help="seed of the random search")
    args = parser.parse_args(argv)
    if spec is not None:
        sweep_cfg = dict(spec)
    else:
        with open(args.config) as f:
            sweep_cfg = yaml.safe_load(f)

    from .__main__ import main as train_main

    rng = np.random.default_rng(args.seed)
    metric_key = sweep_cfg.get("metric", "val_combined")
    os.makedirs(args.output, exist_ok=True)
    results_path = os.path.join(args.output, "sweep_results.jsonl")
    results = []
    for i, trial in enumerate(trial_overrides(sweep_cfg, rng)):
        trial_args = (["--out", os.path.join(args.output, f"trial_{i:03d}")] + train_args
                      + list(sweep_cfg.get("command_overrides", []))
                      + [f"{k}={v}" for k, v in trial.items()])
        print(f"=== trial {i}: {trial}", flush=True)
        try:
            metrics = train_main(trial_args).metrics
            record = {"trial": i, "params": trial,
                      "metrics": {k: float(v) for k, v in metrics.items()}}
        except Exception as e:  # a failed trial is a result of the sweep
            record = {"trial": i, "params": trial, "error": f"{type(e).__name__}: {e}"}
        results.append(record)
        with open(results_path, "a") as f:
            f.write(json.dumps(record) + "\n")
    scored = sorted((r for r in results if metric_key in r.get("metrics", {})),
                    key=lambda r: r["metrics"][metric_key])
    for rank, r in enumerate(scored):
        print(f"rank {rank}: trial {r['trial']} {metric_key}={r['metrics'][metric_key]:.5g} "
              f"params={r['params']}")
    return results


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
