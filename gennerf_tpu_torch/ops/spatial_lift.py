"""The spatial encoder's lift: every ResNet map resized to the stem's size
(align-corners bilinear), concatenated along channels and projected by the
1x1 `proj` conv with its bias (models/spatial_encoder.py).

`resize_bilinear_align_corners` is the resize (the reference's four-tap
formula, as a width pass then a height pass, each `_lerp_axis`).
`spatial_lift(maps, weight, bias)` is resize, concat and proj as one
torch.autograd.Function whose latent never reaches device memory:

- forward: csrc/spatial_lift.cu for CUDA tensors (bf16: the kernel's
  values of the latent are bit-equal to the resizes', its products sum in
  f32 in another order than cuDNN's), `spatial_lift_plain` (the unfused
  code: the resizes, torch.cat, the cast conv) for CPU tensors;
- backward, reassociated, in float32 (float64 stays float64): with g the
  output's gradient, each map's G_l = R_l^T g, the transpose of its resize
  taken at the map's own resolution (the kernel's gather, no atomics, for
  CUDA tensors; two products with the interpolation matrices otherwise),
  then d f_l = W_l^T G_l and d W_l = G_l f_l^T over every image's pixels
  (torch.matmul) and d bias = sum g. Gradients come back in the inputs' dtypes.

The path takes 1 to 5 maps with channel counts that are multiples of 16,
out_channels a multiple of 8 up to 256, and sizes whose kernel grids fit
in int32; `check_lift` raises on anything else before any work.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import kernels
from .coords import linspace

MAX_MAPS = 5
MAX_OUT_CHANNELS = 256
# the kernels' grids (one dimension, int32): the forward's blocks take 64
# output pixels of one image, the gather's 256 texels of one map's plane
INT_MAX = 2 ** 31 - 1
LIFT_ROWS, GATHER_THREADS = 64, 256
# the kernel's packed weight rows: out_channels rounded up to one of these
WEIGHT_ROWS = (32, 64, 128, 256)


def _lerp_taps(size: int, out_size: int, dtype: torch.dtype, device):
    """The align-corners taps of one axis resized from `size` to `out_size`
    samples: (i0, i1, w), w in `dtype`. The source coordinates are rounded
    as the reference's compiled jnp.linspace (F.interpolate computes them in
    another order, which moves `floor` at exact texel hits)."""
    src = linspace(0.0, size - 1.0, out_size, device)
    i0 = torch.floor(src).to(torch.int64).clamp(0, size - 1)
    i1 = (i0 + 1).clamp(0, size - 1)
    return i0, i1, (src - i0.to(src.dtype)).to(dtype)


def _lerp_axis(x: torch.Tensor, dim: int, out_size: int) -> torch.Tensor:
    """Align-corners linear resize of one axis: x[i0] * (1 - w) + x[i1] * w,
    each op in x's dtype."""
    i0, i1, w = _lerp_taps(x.shape[dim], out_size, x.dtype, x.device)
    shape = [1] * x.dim()
    shape[dim] = out_size
    w = w.reshape(shape)
    return x.index_select(dim, i0) * (1 - w) + x.index_select(dim, i1) * w


def resize_bilinear_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, OH, OW) with align_corners=True: the width
    pass, then the height pass. The values equal the reference's four-tap
    formula term for term: its top row is the width pass at row y0, its
    bottom row the width pass at row y1."""
    OH, OW = (int(s) for s in out_hw)
    if (OH, OW) == tuple(x.shape[-2:]):
        return x
    return _lerp_axis(_lerp_axis(x, 3, OW), 2, OH)


@functools.lru_cache(maxsize=64)
def lerp_table(size: int, out_size: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The kernels' int32 tap table of one axis resized from `size` to
    `out_size` samples, on `device`: i0 | i1 | w | 1 - w (the float32 bits
    of the weights `_lerp_axis` uses in `dtype`, 1 - w taken in `dtype`) |
    lo | hi, where output samples lo[i]..hi[i]-1 are the only ones whose
    taps touch input sample i. Cached (it depends on the sizes alone); the
    kernels only read it."""
    i0, i1, w = _lerp_taps(size, out_size, dtype, device)
    outs = torch.arange(out_size, device=device)
    lo = torch.full((size,), out_size, dtype=torch.int64, device=device)
    hi = torch.zeros(size, dtype=torch.int64, device=device)
    for i in (i0, i1):
        lo.scatter_reduce_(0, i, outs, "amin")
        hi.scatter_reduce_(0, i, outs + 1, "amax")
    lo = torch.minimum(lo, hi)  # an untouched sample: the empty range 0..0
    i32 = torch.int32
    return torch.cat([i0.to(i32), i1.to(i32), w.float().view(i32), (1 - w).float().view(i32),
                      lo.to(i32), hi.to(i32)])


@functools.lru_cache(maxsize=64)
def _map_table(h: int, w: int, H: int, W: int, dtype, device) -> torch.Tensor:
    """A map's tap tables for the forward kernel: its x table, then its y."""
    return torch.cat([lerp_table(w, W, dtype, device), lerp_table(h, H, dtype, device)])


def check_lift(maps: Sequence[torch.Tensor], weight: torch.Tensor,
               bias: Optional[torch.Tensor]) -> None:
    """Raise ValueError unless the lift takes these: 1 to 5 (N, C, h, w)
    maps of one batch with C a multiple of 16, a (cout, sum C, 1, 1) weight
    with cout a multiple of 8 up to 256, and a (cout,) bias, at sizes whose
    kernel grids (N times the first map's 64-pixel tiles; N * cout times a
    resized map's 256-texel tiles) and planes stay within int32."""
    if not 1 <= len(maps) <= MAX_MAPS:
        raise ValueError(f"the lift takes 1 to {MAX_MAPS} maps, got {len(maps)}")
    N = maps[0].shape[0]
    for f in maps:
        if f.dim() != 4 or f.shape[0] != N or f.shape[1] % 16 or f.shape[1] == 0:
            raise ValueError(f"the lift takes (N, C, h, w) maps of one batch with C a multiple "
                             f"of 16, got {[tuple(m.shape) for m in maps]}")
    K = sum(f.shape[1] for f in maps)
    cout = weight.shape[0]
    if tuple(weight.shape) != (cout, K, 1, 1) or cout % 8 or not 0 < cout <= MAX_OUT_CHANNELS:
        raise ValueError(f"the lift takes a (cout, {K}, 1, 1) weight with cout a multiple of 8 "
                         f"up to {MAX_OUT_CHANNELS}, got {tuple(weight.shape)}")
    if bias is None or tuple(bias.shape) != (cout,):
        raise ValueError(f"the lift takes a ({cout},) bias, got "
                         f"{None if bias is None else tuple(bias.shape)}")
    H, W = maps[0].shape[-2:]
    blocks = max([N * -(-H * W // LIFT_ROWS)]
                 + [N * cout * -(-f.shape[2] * f.shape[3] // GATHER_THREADS) for f in maps
                    if f.shape[-2:] != (H, W)])
    if blocks > INT_MAX or max(f.shape[2] * f.shape[3] for f in maps) > INT_MAX - GATHER_THREADS:
        raise ValueError(f"the lift's grids take at most {INT_MAX} blocks and planes of at most "
                         f"{INT_MAX - GATHER_THREADS} pixels, got {blocks} blocks for "
                         f"{[tuple(m.shape) for m in maps]} -> {cout} channels")


def spatial_lift_plain(maps: Sequence[torch.Tensor], weight: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """The unfused lift in the maps' dtype: every map resized to the first
    one's size, concatenated, the 1x1 conv of the weight cast to that
    dtype, then the bias in it (models/resnet._CastConv's order)."""
    dt = maps[0].dtype
    target = maps[0].shape[-2:]
    latent = torch.cat([resize_bilinear_align_corners(f, target) for f in maps], dim=1)
    y = F.conv2d(latent, weight.to(dt))
    return y + bias.to(dt).reshape(-1, 1, 1)


def spatial_lift_float64(maps: Sequence[torch.Tensor], weight: torch.Tensor,
                         bias: torch.Tensor, taps_dtype: torch.dtype) -> torch.Tensor:
    """The unfused lift in float64 on float64 maps, with the interpolation
    weights w and 1 - w rounded as `_lerp_axis` rounds them in `taps_dtype`:
    the referee of a lift computed in `taps_dtype`, which leaves out only
    that lift's rounding of its values and sums."""
    f64 = torch.float64
    H, W = maps[0].shape[-2:]

    def axis(x, dim, out_size):
        i0, i1, w = _lerp_taps(x.shape[dim], out_size, taps_dtype, x.device)
        shape = [1] * x.dim()
        shape[dim] = out_size
        return (x.index_select(dim, i0) * (1 - w).to(f64).reshape(shape)
                + x.index_select(dim, i1) * w.to(f64).reshape(shape))

    latent = torch.cat([f if f.shape[-2:] == (H, W) else axis(axis(f, 3, W), 2, H)
                        for f in maps], dim=1)
    return F.conv2d(latent, weight.to(f64)) + bias.to(f64).reshape(-1, 1, 1)


def pack_lift_weight(weight: torch.Tensor, rows: int) -> torch.Tensor:
    """(cout, K, 1, 1) -> the kernel's bf16 weight operand: element (o, k) at
    flat index ((k // 8) * rows + o) * 8 + k % 8 (the wgmma K-major layout of
    8x8 core matrices, slab after slab along K), rows past cout zero."""
    cout, K = weight.shape[:2]
    w = weight.reshape(cout, K).to(torch.bfloat16)
    if rows > cout:
        w = torch.cat([w, w.new_zeros(rows - cout, K)])
    return w.reshape(rows, K // 8, 8).permute(1, 0, 2).contiguous()


@torch.no_grad()
def spatial_lift_cuda(maps: Sequence[torch.Tensor], weight: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """The lift kernel on bf16 CUDA maps -> (N, cout, H, W) bf16, H, W the
    first map's size."""
    check_lift(maps, weight, bias)
    bf16 = torch.bfloat16
    maps = [f.contiguous() for f in maps]
    for i, f in enumerate(maps):
        kernels.check_cuda_tensor(f, f"maps[{i}]", bf16)
    dev = maps[0].device
    N, _, H, W = maps[0].shape
    cout = weight.shape[0]
    rows = next(r for r in WEIGHT_ROWS if r >= cout)
    packed = pack_lift_weight(weight.to(dev), rows)
    b = bias.to(dev, bf16).contiguous()
    tables = [None if f.shape[-2:] == (H, W)
              else _map_table(f.shape[2], f.shape[3], H, W, bf16, dev) for f in maps]
    out = torch.empty(N, cout, H, W, dtype=bf16, device=dev)
    L = len(maps)
    ints = [(ctypes.c_int * L)(*[f.shape[d] for f in maps]) for d in (1, 2, 3)]
    kernels.SPATIAL_LIFT.launch(
        L, (ctypes.c_void_p * L)(*[f.data_ptr() for f in maps]),
        (ctypes.c_void_p * L)(*[None if t is None else t.data_ptr() for t in tables]),
        *ints, packed.data_ptr(), b.data_ptr(), out.data_ptr(), N, cout, rows, H, W,
        kernels.stream_ptr(dev))
    return out


def resize_transpose_plain(g: torch.Tensor, hw: Tuple[int, int],
                           dtype: torch.dtype) -> torch.Tensor:
    """R^T g: the transpose of the (h, w) -> g's (H, W) resize (the taps of
    a map in `dtype`) applied to g (N, C, H, W), in g's dtype, as two
    products with the axes' interpolation matrices."""
    H, W = g.shape[-2:]

    def matrix(size, out_size):  # (out_size, size): row o holds 1 - w at i0, w at i1
        i0, i1, w = _lerp_taps(size, out_size, dtype, g.device)
        m = torch.zeros(out_size, size, dtype=g.dtype, device=g.device)
        o = torch.arange(out_size, device=g.device)
        m.index_put_((o, i0), (1 - w).to(g.dtype), accumulate=True)
        m.index_put_((o, i1), w.to(g.dtype), accumulate=True)
        return m

    return torch.matmul(matrix(hw[0], H).t(), torch.matmul(g, matrix(hw[1], W)))


@torch.no_grad()
def resize_transpose_cuda(g: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """The gather kernel: R^T g in f32 (N, C, h, w) for a bf16 CUDA g (N, C,
    H, W) and a bf16 map of size hw."""
    bf16 = torch.bfloat16
    g = g.contiguous()
    kernels.check_cuda_tensor(g, "g", bf16)
    N, C, H, W = g.shape
    h, w = hw
    dev = g.device
    out = torch.empty(N, C, h, w, dtype=torch.float32, device=dev)
    kernels.LIFT_RESIZE_T.launch(
        g.data_ptr(), out.data_ptr(), lerp_table(w, W, bf16, dev).data_ptr(),
        lerp_table(h, H, bf16, dev).data_ptr(), N * C, H, W, h, w, kernels.stream_ptr(dev))
    return out


class _Lift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, weight, bias, *maps):
        ctx.save_for_backward(weight, *maps)
        if maps[0].is_cuda:
            return spatial_lift_cuda(maps, weight, bias)
        return spatial_lift_plain(maps, weight, bias)

    @staticmethod
    def backward(ctx, g):
        weight, *maps = ctx.saved_tensors
        need_w, need_b, *need_maps = ctx.needs_input_grad
        acc = torch.promote_types(g.dtype, torch.float32)
        N, cout, H, W = g.shape
        ga = g.to(acc)
        grad_b = ga.sum((0, 2, 3)).to(weight.dtype) if need_b else None
        grad_maps, grad_w = [], []
        k0 = 0
        for f, need in zip(maps, need_maps):
            C, h, w = f.shape[1:]
            w_l = weight[:, k0:k0 + C].reshape(cout, C).to(acc)
            k0 += C
            if (h, w) == (H, W):
                G = ga
            elif g.is_cuda:
                G = resize_transpose_cuda(g, (h, w))
            else:
                G = resize_transpose_plain(ga, (h, w), f.dtype)
            G = G.reshape(N, cout, h * w)
            grad_maps.append(torch.matmul(w_l.t(), G).reshape(f.shape).to(f.dtype)
                             if need else None)
            if need_w:
                # one product over every image's pixels (a batch over the images
                # leaves cuBLAS too few tiles): both operands channel-major
                g_cm = torch.empty(cout, N, h * w, dtype=acc, device=g.device)
                f_cm = torch.empty(C, N, h * w, dtype=acc, device=g.device)
                g_cm.copy_(G.transpose(0, 1))
                f_cm.copy_(f.reshape(N, C, h * w).transpose(0, 1))
                grad_w.append(torch.mm(g_cm.reshape(cout, -1), f_cm.reshape(C, -1).t()))
        grad_weight = (torch.cat(grad_w, 1).reshape(weight.shape).to(weight.dtype)
                       if need_w else None)
        return (grad_weight, grad_b, *grad_maps)


def spatial_lift(maps: Sequence[torch.Tensor], weight: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """The lift of `maps` (the stem's first: its size is the output's) by
    the (cout, K, 1, 1) weight and (cout,) bias -> (N, cout, H, W) in the
    maps' dtype; differentiable in the maps, the weight and the bias."""
    check_lift(maps, weight, bias)
    return _Lift.apply(weight, bias, *maps)
