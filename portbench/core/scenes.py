"""Synthetic rooms on the device, from a seed: an axis-aligned room shell
seen from inside, furniture boxes on its floor, posed RGB-D frames by ray
casting, and the analytic truncated signed distance of the room as ground
truth. The torch rewrite of the ideas in the port's
`data/synthetic.training_batch` and `data/prepare/synthetic_scannet.room_poses`
(numpy, on the host): the same kind of room and camera ring, made in a few
large calls on the card so that set-up stays short.

Conventions (the port's): `projection` (3, 4) maps world points to pixels
(K [R | t] of the world-to-camera pose), `pose` (4, 4) is camera-to-world
with +z forward and +y down, depth is the camera z of the hit (0 = none),
images are float32 RGB in [0, 1]. Work does not depend on the seed: every
seed gives the same number of rooms, frames, pixels and boxes.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

# ScanNet's depth intrinsics at 640 x 480, scaled to other frame sizes
FX, FY, CX, CY, W0, H0 = 577.87, 577.87, 319.5, 239.5, 640, 480
FLOOR_Z = 0.16  # the floor's height above the volume's bottom (the reference generator's)


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one stream of draws of a run's seed (any
    whole number; streams of one seed differ)."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 0x9E3779B97F4A7C15 + stream) % (1 << 64))


def _uniform(gen: torch.Generator, shape, lo: float, hi: float, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def intrinsics(height: int, width: int, device=None) -> torch.Tensor:
    sx, sy = width / W0, height / H0
    return torch.tensor([[FX * sx, 0.0, (CX + 0.5) * sx - 0.5],
                         [0.0, FY * sy, (CY + 0.5) * sy - 0.5],
                         [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)


def look_at(eye: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(T, 3) eyes and targets -> (T, 4, 4) camera-to-world poses, +z
    forward, +y down, the world's +z up."""
    fwd = target - eye
    fwd = fwd / fwd.norm(dim=-1, keepdim=True)
    up = torch.tensor([0.0, 0.0, 1.0], device=eye.device).expand_as(fwd)
    right = torch.cross(fwd, up, dim=-1)
    right = right / right.norm(dim=-1, keepdim=True)
    down = torch.cross(fwd, right, dim=-1)
    pose = torch.zeros(eye.shape[0], 4, 4, device=eye.device)
    pose[:, :3, 0], pose[:, :3, 1], pose[:, :3, 2], pose[:, :3, 3] = right, down, fwd, eye
    pose[:, 3, 3] = 1.0
    return pose


def room_layout(gen: torch.Generator, grid_extent: Sequence[float], room: Dict,
                device) -> Dict[str, torch.Tensor]:
    """One room: its shell [lo, hi] (3,) centred in x and y on the grid,
    its floor FLOOR_Z above the grid's bottom, and `room["boxes"]` boxes
    standing on the floor inside it (k, 3) box_lo / box_hi."""
    ex, ey, ez = (float(e) for e in grid_extent)
    sxy = _uniform(gen, (2,), *room["xy_frac"], device) * torch.tensor([ex, ey], device=device)
    h = _uniform(gen, (1,), *room["height_frac"], device) * (ez - FLOOR_Z)
    centre = torch.tensor([ex / 2, ey / 2], device=device)
    lo = torch.cat([centre - sxy / 2, torch.tensor([FLOOR_Z], device=device)])
    hi = torch.cat([centre + sxy / 2, FLOOR_Z + h])
    k = int(room["boxes"])
    size = torch.stack([_uniform(gen, (k,), *room["box_xy_m"], device),
                        _uniform(gen, (k,), *room["box_xy_m"], device),
                        _uniform(gen, (k,), *room["box_h_m"], device)], dim=-1)
    free = (hi[:2] - lo[:2])[None] - size[:, :2] - 0.2
    pos = lo[:2][None] + 0.1 + torch.rand(k, 2, generator=gen, device=device) * free
    box_lo = torch.cat([pos, torch.full((k, 1), FLOOR_Z, device=device)], dim=-1)
    return {"lo": lo, "hi": hi, "box_lo": box_lo, "box_hi": box_lo + size}


def ring_poses(gen: torch.Generator, layout: Dict[str, torch.Tensor], frames: int,
               room: Dict) -> torch.Tensor:
    """(T, 4, 4) poses evenly spaced over an arc of `room["arc_turns"]`
    turns of a ring inside the room, each looking across the room's centre
    at the far side, angle and height jittered."""
    lo, hi = layout["lo"], layout["hi"]
    device = lo.device
    centre = (lo + hi) / 2
    radius = float(room["ring_frac"]) * float((hi[:2] - lo[:2]).min()) / 2
    a0 = float(torch.rand(1, generator=gen, device=device)) * 2 * math.pi
    t = torch.arange(frames, dtype=torch.float32, device=device)
    ang = a0 + 2 * math.pi * float(room["arc_turns"]) * t / frames \
        + 0.02 * torch.randn(frames, generator=gen, device=device)
    height = FLOOR_Z + _uniform(gen, (frames,), *room["eye_m"], device)
    eye = torch.stack([centre[0] + radius * torch.cos(ang), centre[1] + radius * torch.sin(ang),
                       height], dim=-1)
    target = torch.stack([centre[0] - 2 * radius * torch.cos(ang),
                          centre[1] - 2 * radius * torch.sin(ang),
                          torch.full_like(ang, FLOOR_Z + 0.6)], dim=-1)
    return look_at(eye, target)


def _safe(d: torch.Tensor) -> torch.Tensor:
    tiny = torch.full_like(d, 1e-12)
    return torch.where(d.abs() < 1e-12, torch.where(d < 0, -tiny, tiny), d)


def cast_depth(layout: Dict[str, torch.Tensor], pose: torch.Tensor, K: torch.Tensor,
               height: int, width: int):
    """Depth (T, H, W) and a shaded RGB image (T, 3, H, W) of the room seen
    through each pose: the nearest of the shell's inside and the boxes'
    outsides along every pixel's ray, parameterized by camera z."""
    device = pose.device
    v, u = torch.meshgrid(torch.arange(height, device=device, dtype=torch.float32),
                          torch.arange(width, device=device, dtype=torch.float32), indexing="ij")
    d_cam = torch.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], torch.ones_like(u)],
                        dim=-1).reshape(-1, 3)
    d = torch.einsum("tij,pj->tpi", pose[:, :3, :3], d_cam)   # (T, P, 3), z-depth parameter
    o = pose[:, None, :3, 3]                                  # (T, 1, 3)
    inv = 1.0 / _safe(d)
    lo, hi = layout["lo"], layout["hi"]
    # leaving the shell: the nearest wall ahead on each axis
    t_wall = torch.where(d > 0, (hi - o) * inv, (lo - o) * inv)
    depth, axis = t_wall.min(dim=-1)
    kind = axis  # 0, 1, 2: wall x, wall y, floor or ceiling
    for b in range(layout["box_lo"].shape[0]):
        t1 = (layout["box_lo"][b] - o) * inv
        t2 = (layout["box_hi"][b] - o) * inv
        t_near = torch.minimum(t1, t2).amax(dim=-1)
        t_far = torch.maximum(t1, t2).amin(dim=-1)
        hit = (t_far >= t_near) & (t_near > 1e-3) & (t_near < depth)
        depth = torch.where(hit, t_near, depth)
        kind = torch.where(hit, torch.full_like(kind, 3 + b), kind)
    point = o + d * depth[..., None]
    shade = 0.55 + 0.45 * torch.sin(point * 3.1 + kind[..., None].float() * 1.7)
    T = pose.shape[0]
    image = shade.reshape(T, height, width, 3).permute(0, 3, 1, 2).contiguous()
    return depth.reshape(T, height, width), image.clamp(0.0, 1.0)


def room_tsdf(layout: Dict[str, torch.Tensor], voxel_dim, voxel_size: float,
              trunc: float) -> torch.Tensor:
    """(1, nx, ny, nz) truncated signed distance of the room's free space at
    the voxels' world positions i * voxel_size (the fused volume's
    convention), in units of `trunc`, clamped to [-1, 1]: positive in free
    space, negative in walls and boxes."""
    nx, ny, nz = (int(n) for n in voxel_dim)
    device = layout["lo"].device
    axes = [torch.arange(n, device=device, dtype=torch.float32) * voxel_size for n in (nx, ny, nz)]
    p = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    sdf = torch.minimum(p - layout["lo"], layout["hi"] - p).amin(dim=-1)
    for b in range(layout["box_lo"].shape[0]):
        c = (layout["box_lo"][b] + layout["box_hi"][b]) / 2
        half = (layout["box_hi"][b] - layout["box_lo"][b]) / 2
        q = (p - c).abs() - half
        box = q.clamp_min(0).norm(dim=-1) + q.amax(dim=-1).clamp_max(0)
        sdf = torch.minimum(sdf, box)
    return (sdf / trunc).clamp(-1.0, 1.0)[None]


def make_scene(gen: torch.Generator, grid_extent, frames: int, height: int, width: int,
               room: Dict, device) -> Dict[str, torch.Tensor]:
    """One room's frames: projection (T, 3, 4), image (T, 3, H, W), depth
    (T, H, W), intrinsics (T, 3, 3), pose (T, 4, 4), and its layout."""
    layout = room_layout(gen, grid_extent, room, device)
    pose = ring_poses(gen, layout, frames, room)
    K = intrinsics(height, width, device)
    depth, image = cast_depth(layout, pose, K, height, width)
    world2cam = torch.linalg.inv(pose.double()).float()
    projection = torch.einsum("ij,tjk->tik", K, world2cam[:, :3, :])
    return {"projection": projection.contiguous(), "image": image, "depth": depth,
            "intrinsics": K.expand(frames, 3, 3).contiguous(), "pose": pose, "layout": layout}


def training_batch(gen: torch.Generator, batch: int, frames: int, height: int, width: int,
                   voxel_dim, voxel_size: float, room: Dict, device,
                   scales_cm: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    """A batch of `batch` rooms on the training volume (origin 0), each with
    `frames` frames and its ground truth vol_XX_tsdf (B, 1, nx, ny, nz) at
    each voxel size XX in cm of `scales_cm` (default: voxel_size alone), the
    volume's extent kept, truncated at 3 voxels of that size."""
    extent = [int(n) * voxel_size for n in voxel_dim]
    scenes: List[Dict] = [make_scene(gen, extent, frames, height, width, room, device)
                          for _ in range(batch)]
    out = {k: torch.stack([s[k] for s in scenes]) for k in
           ("projection", "image", "depth", "intrinsics", "pose")}
    for cm in scales_cm or [round(voxel_size * 100)]:
        vs = cm / 100.0
        dims = [round(e / vs) for e in extent]
        out["vol_%02d_tsdf" % cm] = torch.stack(
            [room_tsdf(s["layout"], dims, vs, 3 * vs) for s in scenes])
    return out
