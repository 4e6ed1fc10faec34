"""Camera projection / unprojection (counterpart of gennerf_tpu/ops/projection.py).

`backproject_fold` sums T frames' backprojected features by one of two
routes, chosen from what the call can observe before any work
(`backproject_kernel_takes`):

- the hand-written kernel csrc/backproject.cu (`backproject_fold_cuda` on
  the pixels of `fold_pixels`) for float32 or bfloat16 features on CUDA with
  no autograd graph to build (grad mode off, or the features not requiring
  grad): one pass that reads each voxel's row in every frame and writes the
  sum and the count once, bit-equal to the composition on the same card;
- the composition of a frame-by-frame gather, mask and add
  (`backproject_fold_plain`) for every other call: CPU tensors, float64,
  and training under autograd.

Both take each voxel's pixel from `voxel_pixels`, frame by frame. Counters:
`backproject.pairs` ((item, frame, voxel) pairs), `backproject.kernel_pairs`
(those the kernel took) and `backproject.observed` (those some pixel sees).
"""
from __future__ import annotations

import math

import torch

from ..utils.spans import count, span
from . import kernels
from .coords import world_coordinates


def homogenize_projection(projection: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) world->image projection -> (..., 4, 4) with a [0,0,0,1] row."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=projection.dtype, device=projection.device)
    bottom = bottom.expand(*projection.shape[:-2], 1, 4)
    return torch.cat([projection, bottom], dim=-2)


def get_3d_points(depth: torch.Tensor, projection: torch.Tensor) -> torch.Tensor:
    """Unproject (B, H, W) depth maps through (B, 3, 4) world->image
    projections: pixel (u, v) with depth d maps through inv([P; 0 0 0 1])
    applied to (u*d, v*d, d, 1). Returns (B, H, W, 3) world points
    (the camera center where depth == 0)."""
    B, H, W = depth.shape
    u = torch.arange(W, dtype=depth.dtype, device=depth.device)[None, :].expand(H, W)
    v = torch.arange(H, dtype=depth.dtype, device=depth.device)[:, None].expand(H, W)
    uv1 = torch.stack([u, v, torch.ones_like(u)], dim=-1)  # (H, W, 3)
    pts_img = uv1[None] * depth[..., None]
    pts_img_h = torch.cat([pts_img, torch.ones_like(pts_img[..., :1])], dim=-1)
    inv_proj = torch.linalg.inv(homogenize_projection(projection))  # (B, 4, 4)
    pts_world_h = torch.einsum("bhwj,bij->bhwi", pts_img_h, inv_proj)
    return pts_world_h[..., :3] / pts_world_h[..., 3:4]


def depth_to_world(projection: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Unproject one (H, W) depth map through its (3, 4) projection:
    (3, H*W) world points, row-major over the pixels."""
    return get_3d_points(depth[None], projection[None])[0].reshape(-1, 3).T


def project_voxels(voxel_dim, voxel_size: float, origin, projection: torch.Tensor,
                   height: int, width: int):
    """Project every voxel center of the grid through (B, 3, 4) projections,
    rounding to the nearest pixel.

    Returns px, py (B, V) int64 clamped in-bounds, pz (B, V) camera depth,
    valid (B, V) bool: inside the image with pz > 0."""
    origin = torch.as_tensor(origin, dtype=torch.float32, device=projection.device)
    world = world_coordinates(voxel_dim, voxel_size, origin)
    world_h = torch.cat([world, torch.ones_like(world[:1])], dim=0)  # (4, V)
    camera = torch.einsum("bij,jv->biv", projection, world_h)  # (B, 3, V)
    return camera_pixels(camera, height, width)


def camera_pixels(camera: torch.Tensor, height: int, width: int):
    """Round (B, 3, V) camera coordinates to pixels, as `project_voxels`
    returns them."""
    z = camera[:, 2]
    safe_z = torch.where(z == 0, torch.full_like(z, 1e-8), z)
    px = torch.round(camera[:, 0] / safe_z).to(torch.int64)
    py = torch.round(camera[:, 1] / safe_z).to(torch.int64)
    valid = (px >= 0) & (py >= 0) & (px < width) & (py < height) & (z > 0)
    return px.clamp(0, width - 1), py.clamp(0, height - 1), z, valid


def voxel_pixels(voxel_dim, voxel_size: float, origin, projection: torch.Tensor, height: int,
                 width: int):
    """Each voxel centre's pixel through (B, 3, 4) projections, as
    `project_voxels` rounds it: flat index py * width + px (B, V) int64 and
    valid (B, V) bool."""
    origin = torch.as_tensor(origin, dtype=torch.float32,
                             device=projection.device).reshape(-1)[:3]
    px, py, _, valid = project_voxels(voxel_dim, voxel_size, origin, projection, height, width)
    return py * width + px, valid


def backproject(voxel_dim, voxel_size: float, origin, projection: torch.Tensor,
                features: torch.Tensor):
    """Lift (B, C, H, W) features along camera rays into the voxel grid:
    each voxel center projects through its frame's (B, 3, 4) world->pixel
    projection and reads the feature of the pixel it rounds to (one dense
    gather per voxel, not a scatter).

    Returns volume (B, C, nx, ny, nz), 0 outside the frustum, and valid
    (B, 1, nx, ny, nz) float {0, 1}."""
    B, C, H, W = features.shape
    nx, ny, nz = (int(d) for d in voxel_dim)
    flat_idx, valid = voxel_pixels(voxel_dim, voxel_size, origin, projection, H, W)
    flat = features.reshape(B, C, H * W)
    # index_select along the pixel axis: its backward is one index_add per
    # frame (deterministic on CUDA under torch.use_deterministic_algorithms)
    cols = [flat[b].index_select(1, flat_idx[b]) for b in range(B)]
    vol = cols[0][None] if B == 1 else torch.stack(cols)
    vol = torch.where(valid[:, None, :], vol, torch.zeros((), dtype=vol.dtype, device=vol.device))
    return vol.reshape(B, C, nx, ny, nz), valid.to(features.dtype).reshape(B, 1, nx, ny, nz)


def backproject_kernel_takes(feat_2d: torch.Tensor) -> bool:
    """Whether `backproject_fold` runs the kernel for these features: on
    CUDA, float32 or bfloat16, and no autograd graph to build (grad mode
    off, or the features not requiring grad; the pixels are rounded, so no
    gradient reaches the projections). Reads the tensor's metadata only."""
    needs_graph = torch.is_grad_enabled() and feat_2d.requires_grad
    return (feat_2d.device.type == "cuda" and feat_2d.dtype in (torch.float32, torch.bfloat16)
            and not needs_graph)


def _feature_scale(projection: torch.Tensor, image_hw, feat_hw) -> torch.Tensor:
    """The (1, 3, 1) factors (Wf/W, Hf/H, 1) that rescale a frame's (B, 3, 4)
    world->image projections to feature pixels (a frame at a time: one
    contiguous product a frame, which the projection reads without a copy)."""
    (H, W), (Hf, Wf) = ((int(s) for s in hw) for hw in (image_hw, feat_hw))
    return torch.tensor([Wf / W, Hf / H, 1.0], dtype=torch.float32,
                        device=projection.device).reshape(1, 3, 1)


def backproject_fold(feat_2d: torch.Tensor, projection: torch.Tensor, image_hw, voxel_dim,
                     voxel_size: float, origin):
    """Sum the backprojected features of T frames into one volume.

    Args:
        feat_2d: (B*T, C, Hf, Wf) features of the folded frame axis.
        projection: (B, T, 3, 4) world->image-pixel projections, rescaled
            here to feature pixels by (Wf/W, Hf/H, 1).
        image_hw: (H, W) of the images the projections address.

    Returns (volume (B, C, nx, ny, nz), valid (B, 1, nx, ny, nz)), both f32
    running sums accumulated frame by frame: by the kernel where
    `backproject_kernel_takes`, by the composition otherwise (see the module
    docstring)."""
    B, T = projection.shape[:2]
    kernel = backproject_kernel_takes(feat_2d)
    with span("gennerf.backproject"):
        if kernel:
            pixel = fold_pixels(projection, image_hw, feat_2d.shape[2:], voxel_dim, voxel_size,
                                origin)
            volume, valid = backproject_fold_cuda(feat_2d, pixel, voxel_dim)
        else:
            volume, valid = backproject_fold_plain(feat_2d, projection, image_hw, voxel_dim,
                                                   voxel_size, origin)
        pairs = B * T * valid[0, 0].numel()
        count("backproject.pairs", pairs)
        count("backproject.kernel_pairs", pairs if kernel else 0)
        count("backproject.observed", valid)
        return volume, valid


def backproject_fold_plain(feat_2d: torch.Tensor, projection: torch.Tensor, image_hw, voxel_dim,
                           voxel_size: float, origin):
    """backproject_fold as a composition of torch ops, frame by frame: an f32
    gather, a mask and an add (differentiable in the features; any device)."""
    B, T = projection.shape[:2]
    C, Hf, Wf = feat_2d.shape[1:]
    scale = _feature_scale(projection, image_hw, (Hf, Wf))
    feat = feat_2d.to(torch.float32).reshape(B, T, C, Hf, Wf)
    volume = valid = None
    for t in range(T):
        vol, val = backproject(voxel_dim, voxel_size, origin, projection[:, t] * scale,
                               feat[:, t])
        volume = vol if volume is None else volume + vol
        valid = val if valid is None else valid + val
    return volume, valid


def fold_pixels(projection: torch.Tensor, image_hw, feat_hw, voxel_dim, voxel_size: float,
                origin) -> torch.Tensor:
    """Each (item, frame, voxel)'s flat pixel index in the (Hf, Wf) feature
    map, -1 where the frame does not see the voxel: (B, T, V) int32, the
    pixels `backproject_fold_plain` reads, frame by frame as it rounds them."""
    B, T = projection.shape[:2]
    Hf, Wf = (int(s) for s in feat_hw)
    scale = _feature_scale(projection, image_hw, (Hf, Wf))
    pixel = torch.empty((B, T, math.prod(int(d) for d in voxel_dim)), dtype=torch.int32,
                        device=projection.device)
    for t in range(T):
        flat, valid = voxel_pixels(voxel_dim, voxel_size, origin, projection[:, t] * scale, Hf,
                                   Wf)
        pixel[:, t] = flat.masked_fill_(~valid, -1)
    return pixel


def backproject_fold_cuda(feat_2d: torch.Tensor, pixel: torch.Tensor, voxel_dim):
    """backproject_fold's sum through csrc/backproject.cu: (B, C, nx, ny, nz)
    and (B, 1, nx, ny, nz) float32, bit-equal to the composition on the same
    card. `pixel` (B, T, V) int32 holds each (item, frame, voxel)'s flat
    pixel index py * Wf + px, -1 where the frame does not see the voxel (an
    index outside [0, Hf*Wf) counts as unseen). The kernel reads the
    features channels-last: unless they are channels_last already, torch's
    channels_last copy makes them so first.
    Raises ValueError before any launch unless the features are a
    (B*T, C, Hf, Wf) float32 or bfloat16 tensor with C and Hf*Wf in
    [1, 2^31), `pixel` a contiguous int32 (B, T, nx*ny*nz) tensor, both on
    one CUDA device."""
    if feat_2d.dim() != 4 or min(feat_2d.shape[1:]) < 1:
        raise ValueError(f"feat_2d: expected (B*T, C, Hf, Wf), got {tuple(feat_2d.shape)}")
    N, C, Hf, Wf = feat_2d.shape
    if C > 2 ** 31 - 1 or Hf * Wf > 2 ** 31 - 1:
        raise ValueError(f"feat_2d: C and the pixel index range Hf*Wf must fit int32, got "
                         f"C={C}, Hf*Wf={Hf * Wf}")
    if feat_2d.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"feat_2d: expected float32 or bfloat16, got {feat_2d.dtype}")
    nx, ny, nz = (int(d) for d in voxel_dim)
    V = nx * ny * nz
    if (pixel.dim() != 3 or pixel.shape[0] * pixel.shape[1] != N or pixel.shape[1] < 1
            or pixel.shape[2] != V):
        raise ValueError(f"pixel: expected (B, T, {V}) with B*T = {N}, got {tuple(pixel.shape)}")
    if V > 2 ** 31 - 1:
        raise ValueError(f"voxel_dim: {V} voxels do not fit int32")
    if pixel.dtype != torch.int32:
        raise ValueError(f"pixel: expected int32, got {pixel.dtype}")
    if not pixel.is_contiguous():
        raise ValueError("pixel: expected a contiguous tensor")
    for t, name in ((feat_2d, "feat_2d"), (pixel, "pixel")):
        if t.device.type != "cuda" or t.device != feat_2d.device:
            raise ValueError(f"{name}: expected a CUDA tensor on {feat_2d.device}, got {t.device}")
    B, T = pixel.shape[:2]
    rows = feat_2d.contiguous(memory_format=torch.channels_last)
    volume = torch.empty((B, C, nx, ny, nz), dtype=torch.float32, device=feat_2d.device)
    valid = torch.empty((B, 1, nx, ny, nz), dtype=torch.float32, device=feat_2d.device)
    kernels.BACKPROJECT.launch(rows.data_ptr(), int(rows.dtype == torch.bfloat16),
                               pixel.data_ptr(), volume.data_ptr(), valid.data_ptr(), B, T, V,
                               Hf * Wf, C, kernels.stream_ptr(feat_2d.device))
    return volume, valid

