"""Time edited copies of the decode kernels against the committed ones, in
one process on one card.

    python -m gennerf_tpu_torch.tools.tile_variants [--variants base,noinject] [--out f.json]

A variant is csrc/ with a list of string edits applied; `base` is csrc/ as
committed. Each is built into `<build dir>/variants/<name>/` and loaded;
then K2 (96x96x56, H 256, 5 blocks) and K3 (2^20 points and one 19,200-point
secant launch, d_in 32, d_code 39, H 256, 5 blocks) are timed for each
variant in turn, then again in the reverse order, on seeded random weights
and inputs, and each variant's outputs are held against the plain bf16-feed
versions on the same inputs. Prints one JSON line per variant and turn, then
a summary with the card's name and power limit. The variants are the
alternatives the tile's design was measured against (PERF.md, Findings).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

from .measure import cuda_ms


def _wgmma_n128() -> str:
    """wgmma_m64n128k16, written out like resnet_tile.cuh's m64n64k16."""
    ops = ", ".join(f"%{i}" for i in range(64))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(64))
    return (
        "__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,\n"
        "                                                 int accumulate) {\n"
        "  asm volatile(\n"
        '      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %66, 0;\\n"\n'
        '      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "\n'
        f'      "{{{ops}}}, "\n'
        '      "%64, %65, p, 1, 1, 0, 0;\\n"\n'
        '      "}\\n"\n'
        f"      : {outs}\n"
        '      : "l"(da), "l"(db), "r"(accumulate));\n'
        "}\n\n")


TILE, GRID, POINT = "resnet_tile.cuh", "grid_decode.cu", "point_decode.cu"
HEAD_CALLS = {GRID: "[&](int r) { return p0 + r < n_pts; });\n",
              POINT: "[&](int r) { return r < rows; });\n"}

# (file, old, new, replace every occurrence)
VARIANTS = {
    "base": [],
    # K2 without its lin_z injection loads (wrong outputs: a bound on their cost)
    "noinject": [(GRID, f"ldg2(z_{a} + z{a}_r[rr] + col)", "make_float2(0.f, 0.f)", False)
                 for a in "yzx"],
    # each element of K2's table sums re-reads its row's (i, j, k) from
    # shared memory and builds its own 64-bit address (after the shared
    # stores of the elements before it, which may alias)
    "index_per_element": [
        (GRID, f"ldg2(z_{a} + z{a}_r[rr] + col)", f"ldg2(z_{a} + {off} + col)", False)
        for a, off in (("y", "(static_cast<size_t>(b) * ny + pos[3 * f.row(rr) + 1]) * H"),
                       ("z", "(static_cast<size_t>(b) * nz + pos[3 * f.row(rr) + 2]) * H"),
                       ("x", "(static_cast<size_t>(pos[3 * f.row(rr)]) * nb + b) * H"))],
    "stages3": [(TILE, "constexpr int kStages = 4;", "constexpr int kStages = 3;", False)],
    "stages2": [(TILE, "constexpr int kStages = 4;", "constexpr int kStages = 2;", False)],
    # 128-wide N-chunks (wgmma m64n128k16, 64 accumulator registers)
    "n128": [
        (TILE, "constexpr int kNC = 64;", "constexpr int kNC = 128;", False),
        (TILE, "float acc[32];", "float acc[64];", False),
        (TILE, "void fence_acc(float (&d)[32]) {\n#pragma unroll\n  for (int i = 0; i < 32; ++i)",
         "void fence_acc(float (&d)[64]) {\n#pragma unroll\n  for (int i = 0; i < 64; ++i)", False),
        (TILE, "// a compile-time int usable in device code", _wgmma_n128()
         + "// a compile-time int usable in device code", False),
        (TILE, "wgmma_m64n64k16(acc, ", "wgmma_m64n128k16(acc, ", False),
        (TILE, "for (int j = 0; j < 8; ++j) {\n      const __nv_bfloat162 w2",
         "for (int j = 0; j < 16; ++j) {\n      const __nv_bfloat162 w2", False),
        (TILE, "const int i = c * 32 + 4 * j + 2 * rr;", "const int i = c * 64 + 4 * j + 2 * rr;",
         False),
    ] + [(f, a, b, True) for f in (GRID, POINT) for a, b in (
        ("float(&acc)[32]", "float(&acc)[64]"), ("for (int j = 0; j < 8; ++j)", "for (int j = 0; j < 16; ++j)"),
        ("c * 32 + ", "c * 64 + "))],
    # the consumers take turns to issue each slab's wgmmas (named barriers 4, 5)
    "pingpong": [
        (TILE, "__device__ __forceinline__ void sync_consumers() { named_barrier(1, kConsumers * 128); }",
         "__device__ __forceinline__ void sync_consumers() { named_barrier(1, kConsumers * 128); }\n"
         "__device__ __forceinline__ void take_turn(int wg) { named_barrier(4 + wg, 256); }\n"
         "__device__ __forceinline__ void pass_turn(int wg) {\n"
         '  asm volatile("bar.arrive %0, %1;\\n" ::"r"(5 - wg), "r"(256) : "memory");\n}', False),
        (TILE, "      wgmma_fence();\n      fence_acc(acc);",
         "      take_turn(f.wg);\n      wgmma_fence();\n      fence_acc(acc);", False),
        (TILE, "      wgmma_commit();\n      wgmma_wait<1>();",
         "      wgmma_commit();\n      pass_turn(f.wg);\n      wgmma_wait<1>();", False),
    ] + [(f, a, b, False) for f in (GRID, POINT) for a, b in (
        ("  const Frag<H> f(threadIdx.x);\n", "  const Frag<H> f(threadIdx.x);\n  if (f.wg == 1) pass_turn(1);\n"),
        (HEAD_CALLS[f], HEAD_CALLS[f] + "  if (f.wg == 0) take_turn(0);\n"))],
}


def make_variant(name: str, build_root: str, csrc: str, variants=None) -> str:
    """csrc/ with the variant's edits (from `variants`, default VARIANTS),
    in its own directory."""
    d = os.path.join(build_root, "variants", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d, ignore=shutil.ignore_patterns("*.o", "*.so"))
    for fname, old, new, every in (VARIANTS if variants is None else variants)[name]:
        path = os.path.join(d, fname)
        with open(path) as f:
            src = f.read()
        if old not in src:
            raise ValueError(f"variant {name}: {fname} lacks {old[:60]!r}")
        with open(path, "w") as f:
            f.write(src.replace(old, new) if every else src.replace(old, new, 1))
    return d


def main(argv=None) -> int:
    import torch

    from ..ops import grid_decode as gd
    from ..ops import kernels
    from ..ops import point_decode as pd
    from ..ops import weight_slabs as ws

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default=None, help="also write the summary JSON here")
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    if not torch.cuda.is_available():
        print("tile_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    H, nb, dims, n = 256, 5, (96, 96, 56), 1 << 20
    nx, ny, nz = dims
    grid_raw = {"w0": rnd(nb, H, H, scale=H ** -0.5), "w1": rnd(nb, H, H, scale=H ** -0.5),
                "b0": rnd(nb, H, scale=0.1), "b1": rnd(nb, H, scale=0.1),
                "w_last": rnd(H, scale=H ** -0.5), "b_last": 0.05, "smoothing": 1.05}
    point_raw = dict(grid_raw, w_in=rnd(32, H, scale=32 ** -0.5), b_in=rnd(H, scale=0.1),
                     wz=rnd(nb, 39, H, scale=39 ** -0.5), bz=rnd(nb, H, scale=0.1), alpha=0.7)
    tables = gd.GridTables(rnd(ny * nz, H), rnd(nx, nz, H), rnd(nx, ny, H),
                           rnd(nx, nb, H, scale=0.3), rnd(nb, ny, H, scale=0.3),
                           rnd(nb, nz, H, scale=0.3))
    feat, code = rnd(n, 32), rnd(n, 39)
    check = 1 << 17  # the plain version's share of the points
    grid_plain = gd.separable_grid_decode_plain(tables, grid_raw, bf16_feeds=True)
    point_plain = pd.fused_resnetfc_tsdf_plain(feat[:check], code[:check], point_raw)

    csrc, build_root, nc = kernels.CSRC_DIR, kernels.build_dir(), ws.NC
    built = {}
    try:
        for name in names:
            kernels.CSRC_DIR = make_variant(name, build_root, csrc)
            kernels._lib = None
            kernels.load_library()
            log = kernels.build_info.get("ptxas", "")
            spills = sorted({int(m) for m in re.findall(r"(\d+) bytes spill stores", log)})
            with open(os.path.join(kernels.CSRC_DIR, TILE)) as f:
                ws.NC = int(re.search(r"constexpr int kNC = (\d+);", f.read()).group(1))
            built[name] = (kernels._lib, ws.pack_decode_weights(grid_raw, point=False),
                           pd.pack_point_weights(point_raw), spills)
            ws.NC = nc
        results = {name: {"grid_ms": [], "point_ms": [], "secant_ms": [], "spill_store_bytes": b[3]}
                   for name, b in built.items()}
        for name in names + names[::-1]:
            lib, gw, pw, _ = built[name]
            kernels._lib = lib
            r = results[name]
            g = gd.grid_decode_cuda(tables, gw)
            p = pd.fused_resnetfc_tsdf_cuda(feat[:check], code[:check], pw)
            torch.cuda.synchronize()
            r["grid_max_abs_err"] = float((g - grid_plain).abs().max())
            r["point_max_abs_err"] = float((p - point_plain).abs().max())
            r["grid_ms"].append(cuda_ms(torch, lambda: gd.grid_decode_cuda(tables, gw), 20))
            r["point_ms"].append(cuda_ms(torch, lambda: pd.fused_resnetfc_tsdf_cuda(feat, code, pw),
                                         10))
            r["secant_ms"].append(cuda_ms(
                torch, lambda: pd.fused_resnetfc_tsdf_cuda(feat[:19200], code[:19200], pw), 20))
            print(json.dumps({"variant": name, **r}), flush=True)
    finally:
        kernels.CSRC_DIR, kernels._lib, ws.NC = csrc, None, nc
    summary = {"card": smi, "shapes": {"grid": list(dims), "points": n, "H": H, "n_blocks": nb},
               "results": results}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
