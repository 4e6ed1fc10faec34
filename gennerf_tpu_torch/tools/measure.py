"""What `chip_smoke.py` measures the kernels with: one device timer and
one reading of the build (ptxas registers and spills per kernel instance,
cuobjdump's HGMMA/HMMA counts) with its gate.

Nothing here imports torch at module level: the timer takes it as an
argument, so the CPU tests can import the parse.
"""
from __future__ import annotations

import os
import re
import shutil
import statistics
import subprocess

# FPS launches a timed sample spans: K1 takes a fraction of a millisecond,
# about the host time of one launch
FPS_INNER = 10


def cuda_ms(torch, fn, reps: int, warmup: int = 2, inner: int = 1) -> float:
    """Median device time of fn() in ms (CUDA events), after warm-up: each
    sample spans `inner` back-to-back calls, so that for a kernel of a
    fraction of a millisecond the host time before each launch overlaps
    the previous launch instead of being counted (inner=1: one call
    between two events, host time included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


KERNEL_OF_ENTRY = (("fps_", "fps"), ("grid_decode_kernel", "grid_decode"),
                   ("point_decode_kernel", "point_decode"), ("spatial_lift_kernel", "spatial_lift"),
                   ("lift_resize_t_kernel", "lift_resize_t"),
                   ("volume_sample_kernel", "volume_sample"), ("backproject_kernel", "backproject"))


def kernel_of(entry: str):
    """(kernel, instance) of a mangled entry name: the width H of a decode
    kernel; the function and its template argument for an FPS kernel (past
    the anonymous namespace's name, which nvcc builds from the file's); the
    packed weight rows (32 per chunk of its template argument) of the lift;
    the element type and channels a thread loads at once of the volume
    sample and of the backprojection ("f32x4", "bf16x8", ...)."""
    for key, name in KERNEL_OF_ENTRY:
        if key in entry:
            if name == "lift_resize_t":
                return name, None
            if name in ("volume_sample", "backproject"):
                m = re.search(name + r"_kernelI(f|13__nv_bfloat16)Li(\d+)E", entry)
                if m is None:
                    return name, entry
                return name, ("f32" if m.group(1) == "f" else "bf16") + "x" + m.group(2)
            if name == "spatial_lift":
                m = re.search(r"spatial_lift_kernelILi(\d+)E", entry)
                return name, 32 * int(m.group(1)) if m else None
            if name == "fps":
                m = re.search(r"(fps_[a-z_]*?kernel)(?:ILi(\d+)E)?", entry)
                if m is None:
                    return name, entry
                return name, f"{m.group(1)}<{m.group(2)}>" if m.group(2) else m.group(1)
            width = re.search(r"decode_kernelILi(\d+)E", entry)
            return name, int(width.group(1)) if width else None
    return None, None


def ptxas_rows(ptxas_log: str) -> dict:
    """Registers and spill bytes from ptxas -v, by (kernel, instance)."""
    rows, cur = {}, None
    for ln in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, inst = kernel_of(m.group(1))
            cur = _row(rows, name, inst) if name else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill_store_bytes"], cur["spill_load_bytes"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    return rows


def _row(rows: dict, name: str, instance) -> dict:
    key = {"fps": "instance", "spatial_lift": "rows", "lift_resize_t": "instance",
           "volume_sample": "instance", "backproject": "instance"}.get(name, "H")
    return rows.setdefault((name, instance), {"kernel": name, key: instance})


def build_report(ptxas_log: str, lib_path: str) -> dict:
    """Per kernel and instance: registers and spill bytes (ptxas_rows), and
    the counts of HGMMA (wgmma) and HMMA (mma.sync) instructions in the
    library's SASS where the toolkit has cuobjdump."""
    rows = ptxas_rows(ptxas_log)
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    sass = None
    if os.path.exists(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                              timeout=300).stdout
        cur = None
        for ln in sass.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                name, inst = kernel_of(m.group(1))
                cur = _row(rows, name, inst) if name else None
                if cur is not None:
                    cur.setdefault("hgmma", 0)
                    cur.setdefault("hmma", 0)
                continue
            if cur is not None:
                cur["hgmma"] += "HGMMA" in ln
                cur["hmma"] += "HMMA" in ln
    return {"cuobjdump": cuobjdump if sass is not None else "missing",
            "kernels": [rows[k] for k in sorted(rows, key=lambda k: (k[0], str(k[1])))]}


def check_build(report: dict) -> None:
    """The decode kernels run on wgmma (HGMMA, no HMMA, where cuobjdump
    exists) and spill nothing at H = 256; no FPS kernel instance spills; the
    lift kernels spill nothing, the lift itself on wgmma; no volume sample
    or backprojection instance spills."""
    for r in report["kernels"]:
        spills = r.get("spill_store_bytes") or r.get("spill_load_bytes")
        if r["kernel"] in ("fps", "volume_sample", "backproject") and spills:
            raise RuntimeError(f"an instance of the {r['kernel']} kernel spills: {r}")
        if r["kernel"] in ("spatial_lift", "lift_resize_t"):
            if spills:
                raise RuntimeError(f"a lift kernel spills: {r}")
            if (r["kernel"] == "spatial_lift" and report["cuobjdump"] != "missing"
                    and (r.get("hgmma", 0) == 0 or r.get("hmma", 0))):
                raise RuntimeError(f"the lift kernel is not on wgmma: {r}")
            continue
        if r["kernel"] not in ("grid_decode", "point_decode"):
            continue
        if r["H"] == 256 and spills:
            raise RuntimeError(f"{r['kernel']} spills at H=256: {r}")
        if report["cuobjdump"] != "missing" and (r.get("hgmma", 0) == 0 or r.get("hmma", 0)):
            raise RuntimeError(f"{r['kernel']} H={r['H']} is not on wgmma: {r}")
