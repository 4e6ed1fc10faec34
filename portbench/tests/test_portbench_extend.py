"""A cell, a configuration, a traffic mix and a per-layer metric added as
new files and entries run without an edit to any file already there."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

from portbench.core import spec

SCRIPT = r"""
import json, sys, time, torch
torch.set_num_threads(2)
from portbench import run
from portbench.core import spec
from portbench.tests.tiny import tiny_gennerf
bench = spec.load_benchmark()
ctx = run.Ctx(bench, "dummy.recon", 5, 0.3, True, torch.device("cpu"), t0=time.perf_counter())
ctx.cfg = tiny_gennerf(ctx.cfg)
res = run.run_cell(ctx)
print(json.dumps({"correct": res["correct"], "metrics": res["metrics"],
                  "attempted": res["attempted"]}))
"""


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".pyc"):
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_dummy_cell_from_new_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.PKG, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = _digests(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench/configs/gennerf_living.json").read_text())
    cfg["name"] = "dummy"
    (root / "portbench/configs/dummy.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/dummy_mix.json").write_text(json.dumps(
        {**json.loads((root / "portbench/traffic/recon_closed.json").read_text()), "pool": 2}))
    (root / "portbench/limits/dummy.recon.json").write_text(
        (root / "portbench/limits/gennerf_living.recon.json").read_text())
    for kind in ("reference", "counts"):
        (root / f"portbench/{kind}/dummy.py").write_text(
            f"from portbench.{kind}.gennerf_living import *  # noqa: F401,F403\n")
    (root / "portbench/metrics/requests_done.dummy.py").write_text(
        "def read(r):\n    return float(r.work['requests'])\n")
    bench["configs"].append({"name": "dummy", "source": "https://example.org/dummy",
                             "file": "portbench/configs/dummy.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy.recon", "config": "dummy", "traffic": "dummy_mix",
                               "chips": 1, "why": "test"})
    bench["end_to_end"][[m["name"] for m in bench["end_to_end"]].index("infer_per_s")][
        "workloads"].append("dummy.recon")
    bench["per_layer"].append({"name": "requests_done.dummy", "unit": "requests",
                               "better": "higher", "source": "host_clock", "layer": "test",
                               "moves": "infer_per_s", "workloads": ["dummy.recon"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{spec.ROOT}")
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["attempted"] > 0
    assert res["metrics"]["requests_done.dummy"]["value"] == res["attempted"]
    after = _digests(root)
    changed = [p for p in before if p != "BENCHMARK.json" and before[p] != after.get(p)]
    assert not changed
