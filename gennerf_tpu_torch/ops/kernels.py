"""Build, load and launch the port's hand-written CUDA kernels.

Every `csrc/*.cu` is compiled by nvcc for sm_90a into one shared library
with a plain C interface, loaded with ctypes (no PyTorch headers, so a
build takes seconds). The build happens on first use, in parallel (one
nvcc per source, all started together), into `GENNERF_TORCH_BUILD_DIR` or
else `gennerf_tpu_torch/_build/`, keyed by a hash of the sources and flags;
nothing is built or imported when this module is imported.

Each kernel has a `Kernel` record whose `launches` counts the launches its
wrapper made, so a run can show that its main path went through it, and
whose `last_launch` holds what a wrapper records of its last launch (the
FPS wrapper: its plan). `KERNELS` are the ports of the JAX package's TPU
kernels (K1-K3); `LIFT_KERNELS` the spatial encoder's lift and its
backward's gather (csrc/spatial_lift.cu), `VOLUME_SAMPLE` the feature
volume's trilinear sample (csrc/volume_sample.cu), and `BACKPROJECT` its
backprojection (csrc/backproject.cu), which replace no TPU kernel.
`fps_plan` asks the FPS launcher how it would run a cloud (no launch).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


class Kernel:
    """A kernel of the library: its C entry point and its launch count."""

    def __init__(self, name: str, symbol: str, argtypes):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.last_launch = None

    def launch(self, *args, record=None) -> None:
        fn = getattr(load_library(), self.symbol)
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error {err}")
        self.launches += 1
        self.last_launch = record


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FPS = Kernel("fps", "gennerf_fps", [_P, _P, _P, _P, _I, _I, _I, _I, _P])
GRID_DECODE = Kernel(
    "grid_decode", "gennerf_grid_decode",
    [_P] * 6 + [_P, _P, _P, _P, _F, _F, _P, _I, _I, _I, _I, _I, _P],
)
POINT_DECODE = Kernel(
    "point_decode", "gennerf_point_decode",
    [_P, _P, ctypes.c_longlong, _I, _I, _I, _I] + [_P] * 6 + [_F, _F, _F, _P, _I, _I, _P],
)
KERNELS = (FPS, GRID_DECODE, POINT_DECODE)
SPATIAL_LIFT = Kernel("spatial_lift", "gennerf_spatial_lift", [_I] + [_P] * 8 + [_I] * 5 + [_P])
LIFT_RESIZE_T = Kernel("lift_resize_t", "gennerf_lift_resize_t", [_P] * 4 + [_I] * 5 + [_P])
LIFT_KERNELS = (SPATIAL_LIFT, LIFT_RESIZE_T)
VOLUME_SAMPLE = Kernel("volume_sample", "gennerf_volume_sample",
                       [_P, _I, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong]
                       + [_I] * 4 + [_F] * 3 + [_P])
BACKPROJECT = Kernel("backproject", "gennerf_backproject",
                     [_P, _I, _P, _P, _P, ctypes.c_longlong, _I, ctypes.c_longlong, _I, _I, _P])
_ALL = KERNELS + LIFT_KERNELS + (VOLUME_SAMPLE, BACKPROJECT)

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def reset_launch_counts() -> None:
    for k in _ALL:
        k.launches = 0


def build_dir() -> str:
    return os.environ.get("GENNERF_TORCH_BUILD_DIR") or os.path.join(_PKG_DIR, "_build")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on the machine with the card")
    return path


def _sources():
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith((".cu", ".cuh"))
    )


def build_library() -> str:
    """Compile the sources (if this exact build is not there yet) and return
    the library's path. Records seconds and ptxas reports in `build_info`."""
    sources = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        with open(path, "rb") as f:
            digest.update(f.read())
    out_dir = os.path.join(build_dir(), digest.hexdigest()[:16])
    lib_path = os.path.join(out_dir, "libgennerf_torch_kernels.so")
    if os.path.exists(lib_path):
        log_path = os.path.join(out_dir, "build.log")
        log = open(log_path).read() if os.path.exists(log_path) else ""
        build_info.update(path=lib_path, seconds=0.0, cached=True, ptxas=log)
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in (s for s in sources if s.endswith(".cu")):
        obj = os.path.join(out_dir, os.path.basename(src) + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", src, "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0:
            failed.append(f"{os.path.basename(src)}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    tmp = lib_path + f".tmp{os.getpid()}"
    link = subprocess.run(
        [nvcc, "-shared", "-o", tmp, *(obj for _, obj, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed\n" + link.stdout)
    os.replace(tmp, lib_path)
    log = "\n".join(logs)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(log)
    build_info.update(path=lib_path, seconds=time.perf_counter() - t0, cached=False, ptxas=log)
    return lib_path


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            for k in _ALL:
                fn = getattr(lib, k.symbol)
                fn.argtypes = k.argtypes
                fn.restype = ctypes.c_int
            lib.gennerf_fps_plan.argtypes = [_I, _I, ctypes.POINTER(_I)]
            lib.gennerf_fps_plan.restype = ctypes.c_int
            _lib = lib
        return _lib


FPS_PLAN_FIELDS = ("active_clusters", "threads", "tier", "points_per_thread", "smem_bytes",
                   "scratch_per_cloud")
# gennerf_fps_plan's tiers by number, best first
FPS_TIERS = ("registers", "shared memory", "device memory")


def fps_plan(N: int, cluster: int) -> dict:
    """How csrc/fps.cu would run clouds of N points on clusters of `cluster`
    CTAs on the current device (its `gennerf_fps_plan`), keyed by
    FPS_PLAN_FIELDS with the tier named; `active_clusters` is
    cudaOccupancyMaxActiveClusters."""
    info = (_I * len(FPS_PLAN_FIELDS))()
    err = load_library().gennerf_fps_plan(N, cluster, info)
    if err != 0:
        raise RuntimeError(f"fps plan for N={N}, cluster={cluster} failed: CUDA error {err}")
    plan = dict(zip(FPS_PLAN_FIELDS, info))
    plan["tier"] = FPS_TIERS[plan["tier"]]
    return plan


def check_cuda_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """Validate a kernel argument before its pointer goes to C."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
