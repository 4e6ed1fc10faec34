#!/usr/bin/env python3
"""Host-side timing of the port's JPEG codec and of the loaders' frame
reduction against PIL's on one host: a 1296x968 ScanNet-sized frame of the
synthetic room (data/prepare/synthetic_scannet.py) encoded at quality 95,
then decoded, encoded, and padded to 1296x972 and reduced to 640x480
(BILINEAR) `--reps` times by each, alternating, one call at a time; the
median ms of each and whether the outputs agree. Needs PIL, which the port
itself never imports (so it runs where PIL is installed, not on the card's
machine).

    python benchmarks/jpeg_codec_vs_pil.py [--reps 40] [--out summary.json]
"""
import argparse
import io
import json
import os
import platform
import statistics
import sys
import time

import numpy as np
from PIL import Image, ImageOps, features

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from gennerf_tpu_torch.data.prepare.synthetic_scannet import COLOR_K, COLOR_SIZE  # noqa: E402
from gennerf_tpu_torch.data.synthetic import look_at_pose, random_primitives, render_scene  # noqa: E402
from gennerf_tpu_torch.utils.image import decode_jpeg, encode_jpeg, resize_bilinear  # noqa: E402


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=40)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    prims = random_primitives(np.random.default_rng(0), "rooms")
    _, frame = render_scene(*COLOR_SIZE, COLOR_K, look_at_pose((0.5, 0.3, 1.2), (0, 0, 0.7)),
                            primitives=prims)
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=95)
    data = buf.getvalue()

    def pil_decode():
        return np.asarray(Image.open(io.BytesIO(data)))

    def pil_encode():
        out = io.BytesIO()
        Image.fromarray(frame).save(out, format="JPEG", quality=95)
        return out.getvalue()

    padded = np.pad(frame, ((2, 2), (0, 0), (0, 0)))
    pil_frame = Image.fromarray(frame)

    def pil_reduce():
        return ImageOps.expand(pil_frame, border=(0, 2)).resize((640, 480), Image.BILINEAR)

    runs = {"port_decode": lambda: decode_jpeg(data), "pil_decode": pil_decode,
            "port_encode": lambda: encode_jpeg(frame, 95), "pil_encode": pil_encode,
            "port_reduce": lambda: resize_bilinear(padded, (640, 480)),
            "pil_reduce": pil_reduce}
    times = {k: [] for k in runs}
    for fn in runs.values():
        fn()  # warm-up (the port's first call builds or loads its library)
    for _ in range(args.reps):
        for name, fn in runs.items():
            t0 = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - t0) * 1e3)
    summary = {"host": f"{platform.machine()} {platform.processor() or ''} "
                       f"{os.cpu_count()} CPUs".strip(),
               "pil": f"Pillow {Image.__version__}, libjpeg-turbo "
                      f"{features.version('libjpeg_turbo')}",
               "frame": list(frame.shape), "bytes": len(data), "reps": args.reps,
               **{f"{k}_ms_median": statistics.median(v) for k, v in times.items()},
               "decode_pixels_equal": bool(np.array_equal(decode_jpeg(data), pil_decode())),
               "encode_bytes_equal": encode_jpeg(frame, 95) == pil_encode(),
               "reduce_pixels_equal": bool(np.array_equal(
                   resize_bilinear(padded, (640, 480)), np.asarray(pil_reduce())))}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
