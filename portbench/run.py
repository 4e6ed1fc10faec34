"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (process start to the first timed request or step): the program's
model with the benchmark's weights from the seed, the cell's scenes on the
card, the warm-up of the cell's own shapes (and, in a training cell, the
first steps the reference follows). Then the window of --seconds. With
--trace 0 the line holds the cell's end-to-end metrics, with --trace 1 its
per-layer metrics, read from the profiler's trace of the window. After the
window the program is freed and the plain reference judges the answers;
each number compared is printed with its limit, last on standard error
and last in the line under "checks".

Exits with 2 and prints no result without as many CUDA cards as the cell
asks for, and with 3 when JAX, flax or the JAX package is loaded.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time


def _process_start() -> float:
    """time.perf_counter() at this process's start, from /proc where it is."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T0 = _process_start()
FORBIDDEN = ("jax", "jaxlib", "flax", "gennerf_tpu")


def cache_dirs(root: str) -> None:
    """Every build and kernel cache of the program at fixed paths inside the
    checkout, so that only a cell's first run there builds."""
    cache = os.path.join(root, ".portbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ.setdefault(var, os.path.join(cache, sub))
    os.environ.setdefault("GENNERF_TORCH_BUILD_DIR",
                          os.path.join(root, "gennerf_tpu_torch", "_build"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


class Ctx:
    """What a driver is given: the cell and its pieces, the run's arguments."""

    def __init__(self, bench: dict, cell: str, seed: int, seconds: float, trace: bool, device,
                 t0: float = T0):
        from .core import spec

        self.bench, self.workload = bench, spec.workload(bench, cell)
        self.cfg = spec.config(bench, self.workload["config"])
        self.traffic = spec.traffic(self.workload["traffic"])
        self.limits = spec.limits(cell)
        self.reference = spec.piece("reference", self.workload["config"])
        self.counts = spec.piece("counts", self.workload["config"])
        self.driver = spec.piece("drivers", self.traffic["driver"])
        self.chips = int(self.workload["chips"])
        self.seed, self.seconds, self.trace, self.device, self.t0 = \
            int(seed), float(seconds), bool(trace), device, t0

    def mark(self, what: str) -> None:
        """Log on standard error how far set-up or the run has come."""
        print(f"portbench: {what} at {time.perf_counter() - self.t0:.3f} s", file=sys.stderr,
              flush=True)


def judge_checks(readings: dict, limits: dict) -> dict:
    """{name: {value, limit}} of every number the cell compares; a number
    without a reading counts as failed."""
    out = {}
    for name, limit in limits["checks"].items():
        v = readings.get(name)
        out[name] = {"value": float("nan") if v is None else float(v), "limit": float(limit)}
    return out


def run_cell(ctx: Ctx) -> dict:
    """One run of the cell: set-up, window, per-layer readings, judgement."""
    import torch

    from .core import readers, spec

    d = ctx.driver
    ctx.mark("imports done")
    st = d.prepare(ctx)
    ctx.mark("weights and scenes made")
    evidence = d.first(ctx, st) if getattr(d, "JUDGES_FIRST_STEPS", False) else None
    ctx.mark("first steps done")
    out = d.window(ctx, st)
    ctx.mark("window closed")
    if evidence is None:
        evidence = out.pop("answers")
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    win = out["window"]
    summary = win.summary()
    metrics = {}
    if ctx.trace:
        r = readers.Reading(ctx.cfg, ctx.counts, summary, win.seconds, ctx.chips, out["work"],
                            d.work_counts(ctx))
        for m in spec.cell_metrics(ctx.bench, ctx.workload["name"], "per_layer"):
            v = spec.piece("metrics", m["name"]).read(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in spec.cell_metrics(ctx.bench, ctx.workload["name"], "end_to_end"):
            metrics[m["name"]] = {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
    d.release(st)
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ctx.mark("per-layer read, program freed")
    judged = d.judge(ctx, st, evidence)
    ctx.mark("judged")
    checks = judge_checks(judged["checks"], ctx.limits)
    correct = out["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "memory_peak_bytes": peak, "summary": summary,
              "window_s": win.seconds, "checks": checks,
              "info": {**out.get("info", {}), **judged.get("info", {})}}
    return result


def result_line(ctx: Ctx, res: dict, card: str) -> dict:
    import torch

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(ctx.device),
              "count": ctx.chips, "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": device, "card": card, "info": res["info"]}
    s = res["summary"]
    if ctx.trace and s is not None:
        device["busy_s"] = s["busy_s"]
        device["window_s"] = res["window_s"]
        line["breakdown"] = {"device_ops": [list(x) for x in s["top_ops"]],
                             "idle_gaps": [list(x) for x in s["idle_gaps"]]}
    line["checks"] = res["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from .core import spec

    cache_dirs(spec.ROOT)
    import torch

    bench = spec.load_benchmark()
    need = int(spec.workload(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: needs {need} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}; no result",
              file=sys.stderr)
        return 2
    from .core import peaks

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = Ctx(bench, args.workload, args.seed, args.seconds, bool(args.trace), device)
    res = run_cell(ctx)
    card = peaks.power_limit()
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded {found} (JAX or the JAX package); no result", file=sys.stderr)
        return 3
    line = result_line(ctx, res, card)
    for name, c in res["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
