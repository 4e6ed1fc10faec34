"""Time the FPS kernel (csrc/fps.cu) against the alternatives of its design,
in one process on one card.

    python -m gennerf_tpu_torch.tools.fps_variants [--variants base,threads512]
        [--clusters 0,1,2,4,8,16] [--parent DIR] [--out f.json]

A source variant is csrc/ with a list of string edits applied (the
mechanism of tools/tile_variants.py); `base` is csrc/ as committed. Each is
built into `<build dir>/fps/variants/<name>/` and loaded. Then every variant
runs at every cluster size (0: the launcher's own choice, else forced) on
three seeded clouds with duplicates, npoint 256: the predict shape
(8, 16384), the training batch of 4 x 8 frames (32, 16384), and one 640x480
frame without presample (1, 307200); the variants in turn, then again in the
reverse order. `--parent DIR` adds the variant `parent`: the fps.cu of the
checkout DIR, the one-block-per-cloud kernel with the C entry
gennerf_fps(xyz, start, out, B, N, npoint, stream) and a 32768-point cap,
called as its wrapper called it, at the two 16384-point shapes.

Times come from tools/measure.py's cuda_ms, as chip_smoke.py's do: `ms`
over FPS_INNER back-to-back launches a sample, and for the launcher's own
choice (and `parent`) also `single_call_ms`, one call between two events,
the wrapper's host time included. Each run's indices are held against the
plain version on the same inputs, except `exchange_only`'s, which are wrong
by construction: its time is the design's dependency floor. Prints one JSON
line per variant and turn, then a summary with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

from .measure import FPS_INNER, cuda_ms, ptxas_rows
from .tile_variants import make_variant

FPS = "fps.cu"

# the text of csrc/fps.cu the variants below replace
_ST_ASYNC = """\
  const uint32_t bar = peer_address(&s.bar[parity], peer);
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(slot), "r"(c.x), "r"(c.y), "r"(c.z), "r"(c.w), "r"(bar) : "memory");
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(slot_z), "r"(__float_as_uint(z)), "r"(bar) : "memory");
"""
_BLOCK_STEP = """\
  if (lane == own) {
    s.warp[warp] = make_uint4(v, i, __float_as_uint(x), __float_as_uint(y));
    s.warp_z[warp] = z;
  }
  __syncthreads();
  if (warp == 0) {
    const uint4 c = s.warp[lane & (kWarps - 1)];
    const float cz = s.warp_z[lane & (kWarps - 1)];
    const unsigned bi = warp_argmax(c.x, c.y);
    const int src = __ffs(__ballot_sync(kFull, c.y == bi)) - 1;
    const uint4 best = make_uint4(__shfl_sync(kFull, c.x, src), bi, __shfl_sync(kFull, c.z, src),
                                  __shfl_sync(kFull, c.w, src));
    const float bz = __shfl_sync(kFull, cz, src);
    if (lane == 0) mbar_expect(&s.bar[parity], cl * kCandBytes);
    if (lane < cl) send(s, parity, rank, lane, best, bz);
  }
"""
_SLOT_READ = """\
  // lane l takes slot l % CL: the CL <= 16 slots repeat in every group of CL lanes
  const uint4 c = s.cand[parity][lane & (cl - 1)];
  const float cz = s.cand_z[parity][lane & (cl - 1)];
"""

# (file, old, new, replace every occurrence)
VARIANTS = {
    "base": [],
    # 128 threads a CTA (4 warps; twice the points a thread)
    "threads128": [(FPS, "constexpr int kThreads = 256;", "constexpr int kThreads = 128;", False)],
    # 512 threads a CTA (16 warps; 16 points a thread at most in registers)
    "threads512": [(FPS, "constexpr int kThreads = 256;", "constexpr int kThreads = 512;", False)],
    # no register tier: every slice takes the loop tier, its coordinates
    # re-read from shared memory and its distances from scratch each iteration
    "smem_cloud": [(FPS, "constexpr int kMaxRegPPT = kThreads <= 256 ? 32 : 16;",
                    "constexpr int kMaxRegPPT = 0;", False)],
    # candidates sent with st.shared::cluster, each iteration closed by a
    # cluster barrier (arrive.release + wait.acquire) instead of st.async
    # completing on the peers' mbarriers
    "cluster_barrier": [
        (FPS, _ST_ASYNC, '  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};"\n'
                         '               ::"r"(slot), "r"(c.x), "r"(c.y), "r"(c.z), "r"(c.w) : "memory");\n'
                         '  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(slot_z), "f"(z) : "memory");\n',
         False),
        (FPS, "    if (lane == 0) mbar_expect(&s.bar[parity], cl * kCandBytes);\n", "", False),
        (FPS, "  mbar_wait(&s.bar[parity], (it >> 1) & 1);", "  cluster_sync();", False),
    ],
    # every warp sends its own candidate to the peers: no __syncthreads and
    # no warp-0 reduce, kWarps times the remote stores and slots
    "warp_slots": [
        (FPS, "  uint4 cand[2][kMaxCluster];", "  uint4 cand[2][kMaxCluster * kWarps];", False),
        (FPS, "  float cand_z[2][kMaxCluster];", "  float cand_z[2][kMaxCluster * kWarps];", False),
        (FPS, _BLOCK_STEP,
         "  const uint4 best = make_uint4(__shfl_sync(kFull, v, own), wi,\n"
         "                                __shfl_sync(kFull, __float_as_uint(x), own),\n"
         "                                __shfl_sync(kFull, __float_as_uint(y), own));\n"
         "  const float bz = __shfl_sync(kFull, z, own);\n"
         "  if (warp == 0 && lane == 0) mbar_expect(&s.bar[parity], cl * kWarps * kCandBytes);\n"
         "  if (lane < cl) send(s, parity, rank * kWarps + warp, lane, best, bz);\n", False),
        (FPS, _SLOT_READ,
         "  const int n = cl * kWarps;\n"
         "  const int j = n < 32 ? (lane & (n - 1)) : lane;\n"
         "  uint4 c = s.cand[parity][j];\n"
         "  float cz = s.cand_z[parity][j];\n"
         "  for (int k = j + 32; k < n; k += 32) {\n"
         "    const uint4 o = s.cand[parity][k];\n"
         "    if (o.x > c.x || (o.x == c.x && o.y < c.y)) {\n"
         "      c = o;\n"
         "      cz = s.cand_z[parity][k];\n"
         "    }\n"
         "  }\n", False),
    ],
    # the register tier's distance update removed (every distance stays 1e10,
    # so every iteration picks index 0): the exchange alone
    "exchange_only": [(FPS, "dist[k] = fminf(dist[k], d);", "dist[k] = fminf(dist[k], 1e10f);",
                       False)],
}
# (name, clouds, points, timed samples): the frame's sizes run 2-55 ms a launch
SHAPES = (("predict", 8, 16384, 20), ("batch", 32, 16384, 20), ("frame", 1, 307200, 3))
NPOINT = 256
PARENT = "parent"
PARENT_MAX_N = 32768


def fps_rows(ptxas_log: str) -> list:
    """The FPS instances' registers and spills, as chip_smoke.py's build gate reads them."""
    return [r for r in ptxas_rows(ptxas_log).values() if r["kernel"] == "fps"]


def load_parent(root: str, build_root: str):
    """The FPS kernel of the checkout `root`, built alone: (its C entry, ptxas rows)."""
    from ..ops import kernels

    d = os.path.join(build_root, "variants", PARENT)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    shutil.copy(os.path.join(root, "gennerf_tpu_torch", "csrc", FPS), d)
    kernels.CSRC_DIR = d
    fn = ctypes.CDLL(kernels.build_library()).gennerf_fps
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, fps_rows(kernels.build_info.get("ptxas", ""))


def parent_fps(fn, xyz, npoint: int, start):
    """The one-block kernel's wrapper as it was: argument checks, the output,
    one launch."""
    import torch

    from ..ops import kernels

    B, N, _ = xyz.shape
    kernels.check_cuda_tensor(xyz, "xyz", torch.float32, (B, N, 3))
    kernels.check_cuda_tensor(start, "start", torch.int32, (B,))
    if not 0 < npoint <= N or N > PARENT_MAX_N:
        raise ValueError(f"fps kernel takes 0 < npoint <= N <= {PARENT_MAX_N}, got {npoint}, {N}")
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    err = fn(xyz.data_ptr(), start.data_ptr(), out.data_ptr(), B, N, npoint,
             kernels.stream_ptr(xyz.device))
    if err != 0:
        raise RuntimeError(f"parent fps kernel launch failed: CUDA error {err}")
    return out


def main(argv=None) -> int:
    import numpy as np
    import torch

    from ..ops import kernels
    from ..ops import sampling as sp

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--clusters", default="0,1,2,4,8,16")
    ap.add_argument("--parent", default=None,
                    help="a checkout whose csrc/fps.cu is the one-block-per-cloud kernel")
    ap.add_argument("--out", default=None, help="also write the summary JSON here")
    args = ap.parse_args(argv)
    names = args.variants.split(",") + ([PARENT] if args.parent else [])
    clusters = [int(c) for c in args.clusters.split(",")]
    if not torch.cuda.is_available():
        print("fps_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    clouds = {}
    for shape, B, N, _ in SHAPES:
        # a presample with replacement of a smaller cloud: duplicates and ties
        base = rng.standard_normal((B, N // 4, 3)).astype(np.float32)
        sel = rng.integers(0, N // 4, (B, N))
        xyz = torch.from_numpy(np.take_along_axis(base, sel[..., None], 1)).to(dev)
        start = torch.from_numpy(rng.integers(0, N, B).astype(np.int32)).to(dev)
        clouds[shape] = (xyz, start, sp.farthest_point_sample_plain(xyz, NPOINT, start))

    def timed(r, fn, reps, single):
        r["ms"].append(cuda_ms(torch, fn, reps, inner=FPS_INNER))
        if single:
            r.setdefault("single_call_ms", []).append(cuda_ms(torch, fn, reps))
        r["us_per_iteration"] = statistics.median(r["ms"]) * 1e3 / NPOINT

    csrc, build_root = kernels.CSRC_DIR, os.path.join(kernels.build_dir(), "fps")
    built, results = {}, {}
    try:
        for name in names:
            if name == PARENT:
                built[name], rows = load_parent(args.parent, build_root)
            else:
                kernels.CSRC_DIR = make_variant(name, build_root, csrc, VARIANTS)
                kernels._lib = None
                built[name] = kernels.load_library()
                rows = fps_rows(kernels.build_info.get("ptxas", ""))
            results[name] = {"build": rows, "runs": {}}
        for name in names + names[::-1]:
            runs = results[name]["runs"]
            if name == PARENT:
                for shape, B, N, reps in SHAPES:
                    if N > PARENT_MAX_N:
                        continue
                    xyz, start, plain = clouds[shape]
                    r = runs.setdefault(f"{shape}/one_block", {"ms": []})
                    fn = lambda: parent_fps(built[name], xyz, NPOINT, start)  # noqa: E731
                    idx = fn()
                    torch.cuda.synchronize()
                    timed(r, fn, reps, single=True)
                    r.update(ctas=B, index_mismatches=int((idx != plain).sum()))
                print(json.dumps({"variant": name, **results[name]}), flush=True)
                continue
            kernels._lib = built[name]
            for shape, B, N, reps in SHAPES:
                xyz, start, plain = clouds[shape]
                for cl in clusters:
                    r = runs.setdefault(f"{shape}/cl{cl}", {"ms": []})
                    fn = lambda: sp.fps_cuda(xyz, NPOINT, start, cl)  # noqa: E731
                    try:
                        idx = fn()
                        torch.cuda.synchronize()
                        plan = dict(kernels.FPS.last_launch)
                        timed(r, fn, reps, single=cl == 0)
                    except RuntimeError as e:  # a cluster size the card refuses
                        r["error"] = str(e)
                        continue
                    r.update({k: plan[k] for k in ("cluster", "ctas", "tier", "points_per_thread",
                                                   "threads", "active_clusters")})
                    if name != "exchange_only":
                        r["index_mismatches"] = int((idx != plain).sum())
            print(json.dumps({"variant": name, **results[name]}), flush=True)
    finally:
        kernels.CSRC_DIR, kernels._lib = csrc, None
    summary = {"card": smi, "npoint": NPOINT, "inner": FPS_INNER,
               "shapes": {s: [B, N, 3] for s, B, N, _ in SHAPES}, "results": results}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f)
    print(json.dumps(summary), flush=True)
    bad = [(n, k) for n, res in results.items() for k, r in res["runs"].items()
           if r.get("index_mismatches")]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
