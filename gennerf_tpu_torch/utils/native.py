"""The port's host C++ library (csrc/host/gennerf_native.cpp) through ctypes:
marching cubes, KD-tree nearest-neighbour distances, the depth rasterizer
and the shaded one, with the signatures and return conventions of the JAX
package's native binding, the baseline JPEG codec (`jpeg_decode`,
`jpeg_encode`) and the 8-bit fixed-point resample pass (`resample_axis`;
utils/image.py wraps these three).

The library is built on first use with the host C++ compiler (`$CXX`, else
`g++`) and the flags in `CXX_FLAGS`, into `ops.kernels.build_dir()` (the
kernels' build directory), keyed by a hash of the source, the flags, the
compiler's `--version` and the machine; a build writes a temporary file
renamed into place, so processes that build at once do not collide.
Nothing is built or loaded when this module is imported. A failed build
or load raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time

import numpy as np

from ..ops.kernels import build_dir

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "csrc", "host", "gennerf_native.cpp")
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
LIB_NAME = "libgennerf_torch_host.so"

_lock = threading.Lock()
_lib = None
build_info: dict = {}

_F32P, _I32P = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
_U8P = ctypes.POINTER(ctypes.c_ubyte)
_SIGNATURES = {
    "free_buffer": (None, [ctypes.c_void_p]),
    "marching_cubes": (ctypes.c_int, [
        _F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(_F32P), ctypes.POINTER(_I32P), _I32P, _I32P]),
    "nn_distances": (None, [_F32P, ctypes.c_int, _F32P, ctypes.c_int, _F32P]),
    "rasterize_depth": (None, [
        _F32P, ctypes.c_int, _I32P, ctypes.c_int, _F32P,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, _F32P]),
    "rasterize_shaded": (None, [
        _F32P, ctypes.c_int, _I32P, ctypes.c_int, _F32P,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, _F32P, _F32P, _U8P, _F32P]),
    "jpeg_decode": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(_U8P), _I32P, _I32P, _I32P,
        ctypes.c_char_p, ctypes.c_int]),
    "jpeg_encode": (ctypes.c_int, [
        _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(_U8P),
        ctypes.POINTER(ctypes.c_long), ctypes.c_char_p, ctypes.c_int]),
    "resample_axis_u8": (None, [
        _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _I32P, _I32P, ctypes.c_int, _U8P]),
}


def _compiler() -> str:
    cxx = os.environ.get("CXX") or "g++"
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(f"host C++ compiler {cxx!r} not found: the port's host library "
                           "(marching cubes, KD-tree, rasterizer) is built with it")
    return path


def build_library() -> str:
    """Compile the host library if this exact build is not there yet and
    return its path; records the path, seconds and whether it was cached in
    `build_info`."""
    cxx = _compiler()
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                             check=True).stdout
    digest = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    for part in (" ".join(CXX_FLAGS), version, platform.machine()):
        digest.update(part.encode())
    out_dir = os.path.join(build_dir(), "host-" + digest.hexdigest()[:16])
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        build_info.update(path=lib_path, seconds=0.0, cached=True)
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.tmp{os.getpid()}"
    t0 = time.perf_counter()
    out = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"building the host library failed:\n{out.stdout}{out.stderr}")
    os.replace(tmp, lib_path)
    build_info.update(path=lib_path, seconds=time.perf_counter() - t0, cached=False)
    return lib_path


def load_library() -> ctypes.CDLL:
    """The loaded host library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _rows3(a, dtype, name: str) -> np.ndarray:
    """`a` as a C-contiguous (n, 3) array of `dtype`; raises for another
    shape, since the C code reads 3 values a row."""
    a = np.ascontiguousarray(a, dtype=dtype)
    if a.ndim != 2 or a.shape[1] != 3:
        raise ValueError(f"{name}: expected shape (n, 3), got {a.shape}")
    return a


def marching_cubes(volume: np.ndarray, level: float = 0.0):
    """The `level` isosurface of a (nx, ny, nz) float volume: vertices
    (V, 3) float32 in voxel coordinates and faces (F, 3) int32."""
    lib = load_library()
    vol = np.ascontiguousarray(volume, dtype=np.float32)
    if vol.ndim != 3:
        raise ValueError(f"volume: expected 3 dimensions, got {vol.shape}")
    nx, ny, nz = vol.shape
    verts_p, faces_p = _F32P(), _I32P()
    nv, nf = ctypes.c_int(), ctypes.c_int()
    rc = lib.marching_cubes(_ptr(vol, ctypes.c_float), nx, ny, nz, ctypes.c_float(level),
                            ctypes.byref(verts_p), ctypes.byref(faces_p),
                            ctypes.byref(nv), ctypes.byref(nf))
    try:
        if rc != 0:
            raise RuntimeError("marching cubes failed to allocate its output")
        verts = (np.ctypeslib.as_array(verts_p, shape=(nv.value, 3)).copy() if nv.value
                 else np.zeros((0, 3), np.float32))
        faces = (np.ctypeslib.as_array(faces_p, shape=(nf.value, 3)).copy() if nf.value
                 else np.zeros((0, 3), np.int32))
    finally:
        lib.free_buffer(verts_p)
        lib.free_buffer(faces_p)
    return verts, faces


def _camera_args(vertices, faces, intrinsics, pose):
    """The arguments both rasterizers share: vertices and faces as
    (n, 3) arrays, the world-to-camera matrix (float32) and fx, fy, cx, cy."""
    v = _rows3(vertices, np.float32, "vertices")
    f = _rows3(faces, np.int32, "faces")
    if len(f) and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError(f"faces index outside the {len(v)} vertices")
    pose, K = np.asarray(pose, np.float64), np.asarray(intrinsics, np.float64)
    if pose.shape != (4, 4) or K.shape != (3, 3):
        raise ValueError(f"expected a (4, 4) pose and (3, 3) intrinsics, got {pose.shape}, "
                         f"{K.shape}")
    w2c = np.ascontiguousarray(np.linalg.inv(pose).astype(np.float32))
    return v, f, w2c, [ctypes.c_float(x) for x in (K[0, 0], K[1, 1], K[0, 2], K[1, 2])]


def rasterize_depth(vertices: np.ndarray, faces: np.ndarray, intrinsics: np.ndarray,
                    pose: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W) float32 z-depth of a mesh (vertices (V, 3) in world space,
    faces (F, 3)) seen by a pinhole camera with (3, 3) `intrinsics` and
    camera-to-world `pose` (4, 4); 0 where no triangle covers the pixel."""
    lib = load_library()
    v, f, w2c, k = _camera_args(vertices, faces, intrinsics, pose)
    out = np.zeros((height, width), dtype=np.float32)
    lib.rasterize_depth(_ptr(v, ctypes.c_float), len(v), _ptr(f, ctypes.c_int), len(f),
                        _ptr(w2c, ctypes.c_float), *k, height, width, _ptr(out, ctypes.c_float))
    return out


def rasterize_shaded(vertices: np.ndarray, faces: np.ndarray, intrinsics: np.ndarray,
                     pose: np.ndarray, height: int, width: int, color, light_dir):
    """A lambert-shaded render of a mesh (arguments as `rasterize_depth`;
    `color` the RGB base colour in [0, 1], `light_dir` a world-space
    direction): (H, W, 3) uint8 on a white background and the (H, W)
    float32 z-depth."""
    lib = load_library()
    v, f, w2c, k = _camera_args(vertices, faces, intrinsics, pose)
    base = np.ascontiguousarray(color, np.float32)
    light = np.ascontiguousarray(light_dir, np.float32)
    if base.shape != (3,) or light.shape != (3,):
        raise ValueError(f"expected 3 colour and 3 light values, got {base.shape}, {light.shape}")
    rgb = np.zeros((height, width, 3), np.uint8)
    depth = np.zeros((height, width), np.float32)
    lib.rasterize_shaded(_ptr(v, ctypes.c_float), len(v), _ptr(f, ctypes.c_int), len(f),
                         _ptr(w2c, ctypes.c_float), *k, height, width,
                         _ptr(base, ctypes.c_float), _ptr(light, ctypes.c_float),
                         _ptr(rgb, ctypes.c_ubyte), _ptr(depth, ctypes.c_float))
    return rgb, depth


def nn_distances(queries: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """(Q,) float32 distance from each query point to its nearest target
    point (inf when there is no target)."""
    lib = load_library()
    q = _rows3(queries, np.float32, "queries")
    t = _rows3(targets, np.float32, "targets")
    out = np.empty(len(q), dtype=np.float32)
    lib.nn_distances(_ptr(q, ctypes.c_float), len(q), _ptr(t, ctypes.c_float), len(t),
                     _ptr(out, ctypes.c_float))
    return out


def _codec_error(status: int, msg) -> Exception:
    text = msg.value.decode(errors="replace")
    return NotImplementedError(text) if status == 1 else ValueError(text)


def jpeg_decode(data: bytes) -> np.ndarray:
    """Baseline JPEG bytes -> (H, W) uint8 for one component, else (H, W, 3)
    RGB, with libjpeg's default decode (islow IDCT, fancy upsampling, its
    YCbCr tables). Progressive, arithmetic-coded, lossless and 12-bit files
    raise NotImplementedError naming the marker; corrupt ones ValueError."""
    lib = load_library()
    buf = ctypes.c_char_p(bytes(data))
    out = _U8P()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(160)
    rc = lib.jpeg_decode(buf, len(data), ctypes.byref(out), ctypes.byref(h), ctypes.byref(w),
                         ctypes.byref(c), msg, len(msg))
    if rc != 0:
        raise _codec_error(rc, msg)
    try:
        shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, c.value)
        return np.ctypeslib.as_array(out, shape=shape).copy()
    finally:
        lib.free_buffer(out)


def jpeg_encode(pixels: np.ndarray, quality: int) -> bytes:
    """(H, W) or (H, W, 3) uint8 -> JPEG bytes as libjpeg writes them at
    `quality`: JFIF, YCbCr 4:2:0 (or grayscale), the standard tables."""
    lib = load_library()
    img = np.ascontiguousarray(pixels, dtype=np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = np.ascontiguousarray(img[:, :, 0])
    if img.ndim not in (2, 3):
        raise ValueError(f"expected an (H, W) or (H, W, 3) image, got {img.shape}")
    channels = 1 if img.ndim == 2 else img.shape[2]
    out = _U8P()
    n = ctypes.c_long()
    msg = ctypes.create_string_buffer(160)
    rc = lib.jpeg_encode(_ptr(img, ctypes.c_ubyte), img.shape[0], img.shape[1], channels,
                         int(quality), ctypes.byref(out), ctypes.byref(n), msg, len(msg))
    if rc != 0:
        raise _codec_error(rc, msg)
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.free_buffer(out)


def resample_axis(img: np.ndarray, axis: int, index: np.ndarray, weight: np.ndarray,
                  bits: int) -> np.ndarray:
    """One 8-bit fixed-point resample pass along `axis` (0 rows, 1 columns)
    of an (H, W, C) uint8 image: output position o is the clipped
    (sum_k weight[o, k] * img[index[o, k]] + 2**(bits-1)) >> bits, with
    (out, taps) int32 index and non-negative weight tables."""
    lib = load_library()
    src = np.ascontiguousarray(img, dtype=np.uint8)
    if src.ndim != 3:
        raise ValueError(f"expected an (H, W, C) image, got {src.shape}")
    index = np.ascontiguousarray(index, dtype=np.int32)
    weight = np.ascontiguousarray(weight, dtype=np.int32)
    H, W, C = src.shape
    out_size, taps = index.shape
    if index.min() < 0 or index.max() >= src.shape[axis]:
        raise ValueError("resample index out of range")
    out = np.empty((out_size, W, C) if axis == 0 else (H, out_size, C), dtype=np.uint8)
    lib.resample_axis_u8(_ptr(src, ctypes.c_ubyte), H, W, C, axis, out_size, taps,
                         _ptr(index, ctypes.c_int), _ptr(weight, ctypes.c_int), bits,
                         _ptr(out, ctypes.c_ubyte))
    return out
