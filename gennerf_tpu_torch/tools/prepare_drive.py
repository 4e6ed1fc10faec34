"""Time the ScanNet preparation path end to end on one synthetic scene:
a 'rooms' scene written as a raw .sens (data/prepare/synthetic_scannet.py),
exported by tools.read_scannet (--tar), unpacked by tools.build_scannet and
prepared by prepare_scannet (info.json, splits, fusion at 4, 8 and 16 cm on
--device). Each stage's seconds go to the summary JSON with the card's
nvidia-smi line.

    python -m gennerf_tpu_torch.tools.prepare_drive --work W --summary S.json
        [--frames 1500] [--distinct 150] [--device cuda] [--threads 8]

--distinct renders that many views and cycles them over the frames, so a
ScanNet-length scene does not pay for rendering every frame (the render
and the .sens write are timed apart from the preparation).
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import time

from ..data.prepare import prepare_data
from ..data.prepare.synthetic_scannet import write_scene
from . import build_scannet, read_scannet
from .quality_drive import card_line


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--work", required=True, help="scratch directory (emptied first)")
    parser.add_argument("--summary", required=True)
    parser.add_argument("--scene", default="scene0244_01")
    parser.add_argument("--frames", type=int, default=1500)
    parser.add_argument("--distinct", type=int, default=150)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--threads", type=int, default=os.cpu_count() or 1)
    args = parser.parse_args(argv)
    shutil.rmtree(args.work, ignore_errors=True)
    raw, export, data = (os.path.join(args.work, d) for d in ("raw", "export", "data"))
    summary = {"card": card_line(), "frames": args.frames, "distinct_views": args.distinct,
               "device": args.device, "loader_threads": prepare_data.LOADER_THREADS}
    written = write_scene(raw, args.scene, args.frames, distinct=args.distinct,
                          threads=args.threads)
    summary.update(render_s=written["render_s"], sens_write_s=written["write_s"],
                   sens_bytes=os.path.getsize(written["sens"]))
    del written
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        read_scannet.main(["--path", raw, "--output", export, "--workers", "1", "--tar"])
        summary["export_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        build_scannet.main(["--source", export, "--target", data, "--workers", "1"])
        summary["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stages = prepare_data.prepare_scannet(data, data, verbose=0, device=args.device)
    summary["prepare_s"] = time.perf_counter() - t0
    summary["prepare_stages_s"] = stages[f"scans/{args.scene}"]
    summary["export_ms_per_frame"] = summary["export_s"] / args.frames * 1e3
    summary["prepare_ms_per_frame"] = summary["prepare_s"] / args.frames * 1e3
    with open(args.summary, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
