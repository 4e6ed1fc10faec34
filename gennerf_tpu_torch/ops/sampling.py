"""Point sampling of the encoder: the uniform presample and farthest-point
sampling (counterpart of gennerf_tpu/ops/sampling.py and the presample in
gennerf_tpu/models/gen_nerf.py:256-267).

`farthest_point_sample` launches the CUDA kernel (csrc/fps.cu, the port of
ops/pallas/fps.py::_fps_kernel) for a CUDA tensor and runs its plain
version `farthest_point_sample_plain` for a CPU tensor. Random draws come
from an explicit torch.Generator, or are passed in (tests inject the JAX
draws, since the two frameworks' generators differ).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernels


def _draw(high: int, shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Uniform int64 in [0, high), drawn on the generator's device."""
    gen_device = generator.device if generator is not None else torch.device("cpu")
    return torch.randint(0, high, shape, generator=generator, device=gen_device).to(device)


def uniform_presample(xyz: torch.Tensor, presample: int,
                      generator: Optional[torch.Generator] = None,
                      sel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Independent uniform presample with replacement per cloud:
    (B, N, 3) -> (B, presample, 3). Off (identity) when presample is 0 or
    N <= presample. `sel` (B, presample) injects the draw."""
    B, N, _ = xyz.shape
    if not presample or N <= presample:
        return xyz
    if sel is None:
        sel = _draw(N, (B, presample), generator, xyz.device)
    sel = sel.to(device=xyz.device, dtype=torch.int64)
    return torch.gather(xyz, 1, sel[..., None].expand(B, presample, 3))


def farthest_point_sample_plain(xyz: torch.Tensor, npoint: int, start: torch.Tensor) -> torch.Tensor:
    """Plain FPS: (B, N, 3) f32 cloud, (B,) start indices -> (B, npoint)
    int32 indices. Distances in f32 from 1e10, written out as
    dx*dx + dy*dy + dz*dz in that order (each op rounded on its own, as
    the kernel's __fmul_rn/__fadd_rn); torch.argmax returns the first
    maximal index, the reference's tie rule."""
    B, N, _ = xyz.shape
    pts = xyz.to(torch.float32)
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    rows = torch.arange(B, device=xyz.device)
    dist = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    far = start.to(device=xyz.device, dtype=torch.int64)
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far
        c = pts[rows, far]  # (B, 3)
        dx = x - c[:, 0:1]
        dy = y - c[:, 1:2]
        dz = z - c[:, 2:3]
        d = dx * dx + dy * dy
        d = d + dz * dz
        dist = torch.minimum(dist, d)
        far = torch.argmax(dist, dim=1)
    return out


def fps_cuda(xyz: torch.Tensor, npoint: int, start: torch.Tensor) -> torch.Tensor:
    """The FPS kernel on a CUDA (B, N, 3) f32 cloud -> (B, npoint) int32."""
    B, N, _ = xyz.shape
    kernels.check_cuda_tensor(xyz, "xyz", torch.float32, (B, N, 3))
    kernels.check_cuda_tensor(start, "start", torch.int32, (B,))
    if not 0 < npoint <= N or N > 32768:
        raise ValueError(f"fps kernel takes 0 < npoint <= N <= 32768, got npoint={npoint}, N={N}")
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    kernels.FPS.launch(xyz.data_ptr(), start.data_ptr(), out.data_ptr(), B, N, npoint,
                       kernels.stream_ptr(xyz.device))
    return out


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          generator: Optional[torch.Generator] = None,
                          start: Optional[torch.Tensor] = None):
    """Farthest-point sampling of (B, N, 3) clouds.

    The start index per cloud is drawn uniformly from `generator` unless
    `start` (B,) injects it. A CUDA cloud goes to the kernel, a CPU cloud
    to the plain version.

    Returns (sampled_xyz (B, npoint, 3), indices (B, npoint) int32)."""
    B, N, _ = xyz.shape
    if start is None:
        start = _draw(N, (B,), generator, xyz.device)
    start = start.to(device=xyz.device, dtype=torch.int32)
    if xyz.device.type == "cuda":
        idx = fps_cuda(xyz.to(torch.float32).contiguous(), npoint, start.contiguous())
    elif xyz.device.type == "cpu":
        idx = farthest_point_sample_plain(xyz, npoint, start)
    else:
        raise ValueError(f"unsupported device {xyz.device}")
    sampled = torch.gather(xyz, 1, idx.to(torch.int64)[..., None].expand(B, npoint, 3))
    return sampled, idx
