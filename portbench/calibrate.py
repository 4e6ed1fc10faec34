"""Readings that the correctness limits are set from, on the card at a
cell's own size: the program's numbers over many seeds, the control's (the
reference computed one precision below the configuration's, in the
program's place) and each planted fault's, in one process.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \
        [--control-seeds 7,8,9] [--fault half_batch --fault-seeds 4,5,6]

Prints one JSON line per seed: {"kind", "seed", "checks", "info"}. It
needs no measured window: a reconstruct cell answers each pool scene once,
a training cell takes its compared steps.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

# readings of many seeds in one process: let freed blocks be reused across sizes
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

from . import run  # noqa: E402
from .core import faults, spec  # noqa: E402


def reading(bench: dict, cell: str, seed: int, kind: str, fault: str = "") -> dict:
    ctx = run.Ctx(bench, cell, seed, 0.0, False, torch.device("cuda", 0), t0=time.perf_counter())
    d = ctx.driver
    st = d.prepare(ctx)
    if kind == "control":
        evidence = d.control(ctx, st)
    elif fault:
        with faults.planted(fault):
            evidence = d.first(ctx, st)
    else:
        evidence = d.first(ctx, st)
    d.release(st)
    gc.collect()
    torch.cuda.empty_cache()
    judged = d.judge(ctx, st, evidence)
    del st, evidence
    gc.collect()
    torch.cuda.empty_cache()
    return {"kind": kind + (f":{fault}" if fault else ""), "seed": seed,
            "checks": judged["checks"], "info": judged.get("info", {})}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)
    run.cache_dirs(spec.ROOT)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench = spec.load_benchmark()
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    plan = ([(s, "program", "") for s in seeds(args.seeds)]
            + [(s, "control", "") for s in seeds(args.control_seeds)]
            + [(s, "program", args.fault) for s in seeds(args.fault_seeds)])
    for seed, kind, fault in plan:
        t = time.perf_counter()
        line = reading(bench, args.workload, seed, kind, fault)
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
