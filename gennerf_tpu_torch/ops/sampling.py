"""Point sampling (counterpart of gennerf_tpu/ops/sampling.py and the
presample in gennerf_tpu/models/gen_nerf.py:256-267): the encoder's
uniform presample, farthest-point sampling and its voxel_hash
alternative (no kernel: sorts and a top-k, in both packages), and the training
supervision's valid-pixel, ray and frustum samplers and the ray samples'
distance bounds (iSDF) with their gradients.

`farthest_point_sample` launches the CUDA kernel (csrc/fps.cu, the port of
ops/pallas/fps.py::_fps_kernel) for a CUDA tensor and runs its plain
version `farthest_point_sample_plain` for a CPU tensor. The kernel runs
each cloud on a thread-block cluster whose size `choose_cluster` takes,
once per device and shape, from the launcher's plan for each size
(`kernels.fps_plan`: occupancy and tier). Random draws come
from an explicit torch.Generator, or are passed in (tests inject the JAX
draws, since the two frameworks' generators differ).
"""
from __future__ import annotations

import functools
import math
import types
from typing import Optional

import torch

from . import kernels


def _gen_device(generator: Optional[torch.Generator]) -> torch.device:
    return generator.device if generator is not None else torch.device("cpu")


def _draw(high: int, shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Uniform int64 in [0, high), drawn on the generator's device."""
    return torch.randint(0, high, shape, generator=generator,
                         device=_gen_device(generator)).to(device)


def draw_uniform(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Uniform float32 in [0, 1), drawn on the generator's device."""
    return torch.rand(shape, generator=generator, device=_gen_device(generator)).to(device)


def draw_normal(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard normal float32, drawn on the generator's device."""
    return torch.randn(shape, generator=generator, device=_gen_device(generator)).to(device)


# -- supervision pixels and rays ---------------------------------------------

def sample_valid_pixels_masked(valid: torch.Tensor, num_samples: int,
                               generator: Optional[torch.Generator] = None,
                               scores: Optional[torch.Tensor] = None):
    """`num_samples` pixels per (H, W) mask of (B, H, W), uniformly without
    replacement among the valid ones: top-k of uniform scores, -inf on
    invalid pixels. A row with fewer valid pixels is filled with invalid
    ones, which `ok` marks. `scores` (B, H*W) injects the draw.

    Returns b (B, 1), h (B, num_samples), w (B, num_samples) int64 and
    ok (B, num_samples) bool."""
    B, H, W = valid.shape
    flat_valid = valid.reshape(B, H * W)
    if scores is None:
        scores = draw_uniform((B, H * W), generator, valid.device)
    scores = torch.where(flat_valid, scores.to(valid.device, torch.float32),
                         torch.full((), float("-inf"), device=valid.device))
    flat_idx = torch.topk(scores, num_samples, dim=1).indices
    ok = torch.gather(flat_valid, 1, flat_idx)
    b = torch.arange(B, device=valid.device)[:, None]
    return b, flat_idx // W, flat_idx % W, ok


def sample_valid_depth_pixels(depth: torch.Tensor, num_samples: int,
                              generator: Optional[torch.Generator] = None,
                              scores: Optional[torch.Tensor] = None):
    """Pixels with nonzero depth (see sample_valid_pixels_masked)."""
    return sample_valid_pixels_masked(depth != 0, num_samples, generator, scores)


def sample_valid_pixels(depth: torch.Tensor, normals: torch.Tensor, num_samples: int,
                        generator: Optional[torch.Generator] = None,
                        scores: Optional[torch.Tensor] = None):
    """Pixels with nonzero depth and a finite (B, H, W, 3) normal (see
    sample_valid_pixels_masked)."""
    valid = (depth != 0) & ~torch.isnan(normals).any(dim=-1)
    return sample_valid_pixels_masked(valid, num_samples, generator, scores)


def _pixels_to_camera_dirs(h: torch.Tensor, w: torch.Tensor, intrinsics: torch.Tensor):
    """Normalized image coords ((v - cy)/fy, (u - cx)/fx) of (B, n) pixels."""
    fx, fy = intrinsics[:, 0, 0][:, None], intrinsics[:, 1, 1][:, None]
    cx, cy = intrinsics[:, 0, 2][:, None], intrinsics[:, 1, 2][:, None]
    return (h - cy) / fy, (w - cx) / fx


def _camera_to_world(xyz_camera: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) camera-space points through (B, 4, 4) camera->world poses."""
    h = torch.cat([xyz_camera, torch.ones_like(xyz_camera[..., :1])], dim=-1)
    world_h = torch.einsum("bij,bnj->bni", pose, h)
    return world_h[..., :3] / world_h[..., 3:4]


def sample_points_in_frustum(h: torch.Tensor, w: torch.Tensor, intrinsics: torch.Tensor,
                             pose: torch.Tensor, min_dist: float, max_dist: float,
                             generator: Optional[torch.Generator] = None,
                             u: Optional[torch.Tensor] = None):
    """Points through (B, n) pixels at depth sqrt(u) * (max - min) + min,
    u uniform in [0, 1): uniform in the frustum's volume. `u` (B, n)
    injects the draw. Returns xyz_world (B, n, 3) and z (B, n)."""
    if u is None:
        u = draw_uniform(h.shape, generator, h.device)
    z = torch.sqrt(u.to(h.device, torch.float32)) * (max_dist - min_dist) + min_dist
    h_norm, w_norm = _pixels_to_camera_dirs(h.to(z.dtype), w.to(z.dtype), intrinsics)
    xyz_camera = torch.stack([w_norm * z, h_norm * z, z], dim=-1)
    return _camera_to_world(xyz_camera, pose), z


def bounds_pc_batch(pc: torch.Tensor, z_vals: torch.Tensor, depth_sample: torch.Tensor):
    """Distance bounds of ray samples to the set of surface samples (iSDF).

    pc (B, R, S, 3) ray samples, the surface sample first on each ray;
    z_vals (B, R, S) their depths; depth_sample (B, R) each ray's surface
    depth. Returns bounds (B, R, S), the distance to the nearest surface
    sample of any ray of the frame, negated behind the surface, and grad
    (B, R, S-1, 3), the unit vector from that surface sample to each
    non-surface sample (negated behind the surface; NaN where the two
    coincide). Builds a (B, R, S, R, 3) difference tensor."""
    surf = pc[:, :, 0]
    diff = pc[:, :, :, None, :] - surf[:, None, None, :, :]
    dists = torch.sqrt((diff * diff).sum(-1))  # (B, R, S, R)
    min_dists, closest = dists.min(dim=-1)
    behind = z_vals > depth_sample[:, :, None]
    bounds = torch.where(behind, -min_dists, min_dists)
    idx = closest[..., None, None].expand(*closest.shape, 1, 3)
    grad = torch.gather(diff, 3, idx)[..., 0, :][:, :, 1:]
    grad = grad / torch.sqrt((grad * grad).sum(-1, keepdim=True))
    grad = torch.where(behind[:, :, 1:, None], -grad, grad)
    return bounds, grad


def sample_points_on_rays(h: torch.Tensor, w: torch.Tensor, depths: torch.Tensor,
                          intrinsics: torch.Tensor, poses: torch.Tensor, N: int, M: int,
                          delta: float, min_dist: float, sigma: float,
                          generator: Optional[torch.Generator] = None,
                          noise: Optional[torch.Tensor] = None):
    """iSDF ray samples through (B, n_rays) pixels of surface depth `depths`:
    the surface point, N stratified points linspace(min_dist, depth + delta)
    and M points depth + sigma * noise. `noise` (B, n_rays, M) injects the
    Gaussian draw.

    Returns xyz_world (B, n_rays, 1+N+M, 3) and z (B, n_rays, 1+N+M)."""
    B, n_rays = depths.shape
    S = 1 + N + M
    # the reference's jnp.linspace with array endpoints, rounded as compiled
    # (ops.coords.linspace): start*(1 - i*r) + i*(stop*r), the last point stop
    stop = depths + delta
    if N > 1:
        r = torch.tensor(1.0, dtype=torch.float32, device=depths.device) / (N - 1)
        i = torch.arange(N - 1, dtype=torch.float32, device=depths.device)
        strat = torch.cat([min_dist * (1 - i * r) + i * (stop[..., None] * r), stop[..., None]], -1)
    else:
        strat = torch.full_like(depths[..., None], min_dist)
    if noise is None:
        noise = draw_normal((B, n_rays, M), generator, depths.device)
    gauss = depths[..., None] + sigma * noise.to(depths.device, depths.dtype)
    z = torch.cat([depths[..., None], strat, gauss], dim=-1)
    h_norm, w_norm = _pixels_to_camera_dirs(h.to(z.dtype), w.to(z.dtype), intrinsics)
    xyz_camera = torch.stack([w_norm[..., None] * z, h_norm[..., None] * z, z], dim=-1)
    xyz_world = _camera_to_world(xyz_camera.reshape(B, n_rays * S, 3), poses)
    return xyz_world.reshape(B, n_rays, S, 3), z


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


FPS_CLUSTERS = (1, 2, 4, 8, 16)


# the largest cluster the launcher takes unless only 16 reaches a better
# tier: 8 ran 3-9% faster than 16 at (8, 16384) and (32, 16384) on the H100
# (PERF.md, tools/fps_variants.py); the exchange grows with the cluster
FPS_AUTO_MAX_CLUSTER = 8


def choose_cluster(B: int, plans: dict) -> int:
    """Cluster size for B clouds, one cluster each, from `kernels.fps_plan`'s
    answer for each size in FPS_CLUSTERS (its `active_clusters` and `tier`).

    Among the sizes whose B clusters the card runs at once, those reaching
    the best tier (kernels.FPS_TIERS order), and of them the largest up to
    FPS_AUTO_MAX_CLUSTER, else the smallest above it. When no size runs B
    clusters at once, the smallest size reaching the best tier (the fewest
    CTAs for the waves that follow)."""
    runs = [cl for cl in FPS_CLUSTERS if plans[cl]["active_clusters"] >= 1]
    if not runs:
        raise RuntimeError(f"the card runs no FPS cluster: {plans}")
    one_wave = [cl for cl in runs if plans[cl]["active_clusters"] >= B]
    pool = one_wave or runs
    best = min(kernels.FPS_TIERS.index(plans[cl]["tier"]) for cl in pool)
    pool = [cl for cl in pool if kernels.FPS_TIERS.index(plans[cl]["tier"]) == best]
    if not one_wave:
        return min(pool)
    small = [cl for cl in pool if cl <= FPS_AUTO_MAX_CLUSTER]
    return max(small) if small else min(pool)


@functools.lru_cache(maxsize=None)
def _launch_plan(lib, device_index: int, B: int, N: int, cluster: int) -> types.MappingProxyType:
    """The plan of a launch of B clouds of N points on `cluster` CTAs a
    cloud (0: choose_cluster's size), with `cluster` and `ctas`: cached per
    kernel library, device and shape, so a launch after the first costs one
    lookup; read-only, since every caller gets the same one."""
    with torch.cuda.device(device_index):
        if not cluster:
            cluster = choose_cluster(B, {cl: kernels.fps_plan(N, cl) for cl in FPS_CLUSTERS})
        return types.MappingProxyType(
            dict(kernels.fps_plan(N, cluster), cluster=cluster, ctas=B * cluster))


def fps_cuda(xyz: torch.Tensor, npoint: int, start: torch.Tensor, cluster: int = 0) -> torch.Tensor:
    """The FPS kernel on a CUDA (B, N, 3) f32 cloud -> (B, npoint) int32.
    Each cloud runs on a cluster of `cluster` CTAs (one of FPS_CLUSTERS);
    0 takes `choose_cluster`'s size for this card and shape. The plan
    launched is left in `kernels.FPS.last_launch`."""
    B, N, _ = xyz.shape
    if not 0 < npoint <= N:
        raise ValueError(f"fps kernel takes 0 < npoint <= N, got npoint={npoint}, N={N}")
    if cluster and cluster not in FPS_CLUSTERS:
        raise ValueError(f"fps cluster must be one of {FPS_CLUSTERS} (or 0), got {cluster}")
    kernels.check_cuda_tensor(xyz, "xyz", torch.float32, (B, N, 3))
    kernels.check_cuda_tensor(start, "start", torch.int32, (B,))
    plan = _launch_plan(kernels.load_library(), xyz.device.index, B, N, cluster)
    scratch_n = plan["scratch_per_cloud"]
    scratch = torch.empty(B * scratch_n, dtype=torch.float32, device=xyz.device) if scratch_n else None
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    kernels.FPS.launch(xyz.data_ptr(), start.data_ptr(), out.data_ptr(),
                       None if scratch is None else scratch.data_ptr(), B, N, npoint,
                       plan["cluster"], kernels.stream_ptr(xyz.device), record=plan)
    return out


def topk_lower_index(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of each row of (B, N), largest
    first and the lower index first among equal values (lax.top_k's
    order; torch.topk promises no order among ties)."""
    return torch.argsort(score, dim=1, descending=True, stable=True)[:, :k]


def voxel_hash_downsample(xyz: torch.Tensor, npoint: int,
                          generator: Optional[torch.Generator] = None,
                          rnd: Optional[torch.Tensor] = None):
    """Voxel-hash sparsification of (B, N, 3) clouds (the 'voxel_hash'
    sparsifier, in place of FPS): one random point per occupied cell of a
    res^3 grid fitted to each cloud's bounding box, res = max(ceil(2 *
    npoint^(1/3)), 2), then random others. `rnd` (B, N) uniform in [0, 1)
    injects the draw.

    The points sort by cell id + rnd/2 in float32 (ties within a cell past
    res^3 of a few thousand: the stable sort keeps them in index order);
    the first point of each cell in that order scores 1 + rnd * 1e-3, the
    others rnd * 1e-3 (rnd by the point's own index, the score by its
    sorted position, as the JAX function), and the npoint best scores
    win, ties to the lower position.

    Returns (sampled_xyz (B, npoint, 3), indices (B, npoint) int32)."""
    B, N, _ = xyz.shape
    res = max(int(math.ceil(npoint ** (1.0 / 3.0) * 2.0)), 2)
    lo = xyz.amin(dim=1, keepdim=True)
    hi = xyz.amax(dim=1, keepdim=True)
    cell = ((xyz - lo) / torch.clamp_min(hi - lo, 1e-6) * res).clamp(0, res - 1).to(torch.int32)
    ids = (cell[..., 0] * res + cell[..., 1]) * res + cell[..., 2]
    if rnd is None:
        rnd = draw_uniform((B, N), generator, xyz.device)
    rnd = rnd.to(device=xyz.device, dtype=torch.float32)
    order = torch.argsort(ids.to(torch.float32) + rnd * 0.5, dim=1, stable=True)
    ids_sorted = torch.gather(ids, 1, order)
    first = torch.cat([torch.ones_like(ids_sorted[:, :1], dtype=torch.bool),
                       ids_sorted[:, 1:] != ids_sorted[:, :-1]], dim=1)
    score = first.to(torch.float32) + rnd * 1e-3
    idx = torch.gather(order, 1, topk_lower_index(score, npoint))
    sampled = torch.gather(xyz, 1, idx[..., None].expand(B, npoint, 3))
    return sampled, idx.to(torch.int32)


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
