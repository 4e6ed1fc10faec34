"""Surface renderer for neural TSDF fields (counterpart of
gennerf_tpu/models/renderer.py): a fixed-step march brackets the first
sign change of the field along each ray, a fine march refines the
bracket, secant steps refine the crossing, and the decode at the surface
point gives its features. Layouts are (B, R) rays as in the reference;
its `lax.map` over ray and point chunks is a Python loop with the same
chunk sizes.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..ops.coords import linspace


class SurfaceRender(NamedTuple):
    depth: torch.Tensor     # (B, R) surface depth along the ray (0 if none)
    points: torch.Tensor    # (B, R, 3) surface points (ray origin if none)
    mask: torch.Tensor      # (B, R) bool: the ray crossed the surface
    features: torch.Tensor  # (B, R, C) decoded features at the surface


def pixels_to_rays(h_idxs: torch.Tensor, w_idxs: torch.Tensor, intrinsics: torch.Tensor,
                   pose: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, R) pixel coords, (B, 3, 3) intrinsics and (B, 4, 4) camera2world
    -> world ray origins and unit directions, each (B, R, 3)."""
    fx = intrinsics[:, 0, 0][:, None]
    fy = intrinsics[:, 1, 1][:, None]
    cx = intrinsics[:, 0, 2][:, None]
    cy = intrinsics[:, 1, 2][:, None]
    dirs_cam = torch.stack([(w_idxs - cx) / fx, (h_idxs - cy) / fy, torch.ones_like(w_idxs)],
                           dim=-1)
    dirs = torch.einsum("bij,brj->bri", pose[:, :3, :3], dirs_cam)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    origins = pose[:, None, :3, 3].expand(dirs.shape)
    return origins, dirs


def _first_crossing(vals: torch.Tensor, ts: torch.Tensor):
    """First + -> - crossing over per-ray sample rows: vals (B, R, S), ts
    (S,) shared or (B, R, S) per ray -> (t_lo, t_hi, f_lo, f_hi, any_cross)."""
    sign_change = (vals[..., :-1] > 0) & (vals[..., 1:] <= 0)  # (B, R, S-1)
    any_cross = sign_change.any(dim=-1)
    # argmax returns the first maximal index, as jnp.argmax over a bool does
    first = sign_change.to(torch.uint8).argmax(dim=-1)
    if ts.dim() == 1:
        t_lo, t_hi = ts[first], ts[first + 1]
    else:
        t_lo = torch.gather(ts, -1, first[..., None])[..., 0]
        t_hi = torch.gather(ts, -1, first[..., None] + 1)[..., 0]
    f_lo = torch.gather(vals, -1, first[..., None])[..., 0]
    f_hi = torch.gather(vals, -1, first[..., None] + 1)[..., 0]
    return t_lo, t_hi, f_lo, f_hi, any_cross


def ray_aabb_clip(origins: torch.Tensor, dirs: torch.Tensor, box_min, box_max, near: float,
                  far: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clip each ray's [near, far] to the axis-aligned box (slab method).
    Rays that miss the box get the empty interval [far, far], where the
    march finds no crossing. -> (t_near, t_far), each (B, R)."""
    tiny = torch.full_like(dirs, 1e-12)
    inv = 1.0 / torch.where(dirs.abs() > 1e-12, dirs, tiny)
    t0 = (box_min - origins) * inv
    t1 = (box_max - origins) * inv
    t_enter = torch.minimum(t0, t1).amax(dim=-1)
    t_exit = torch.maximum(t0, t1).amin(dim=-1)
    t_near = t_enter.clamp(near, far)
    t_far = t_exit.clamp(near, far)
    hit = t_exit > t_enter.clamp(min=near)
    far_t = torch.full_like(t_near, far)
    return torch.where(hit, t_near, far_t), torch.where(hit, t_far, far_t)


def _secant(t_lo, f_lo, t_hi, f_hi):
    denom = f_hi - f_lo
    return torch.where(denom.abs() > 1e-12, t_lo - f_lo * (t_hi - t_lo) / denom,
                       0.5 * (t_lo + t_hi))


def ray_march_tsdf(tsdf_fn: Callable[[torch.Tensor], torch.Tensor], origins: torch.Tensor,
                   dirs: torch.Tensor, near: float = 0.05, far: float = 4.0, n_steps: int = 64,
                   n_secant_steps: int = 8, n_fine_steps: int = 0, convention: str = "fusion",
                   aabb: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """The first outside -> inside zero crossing along each ray.

    `convention="fusion"` (the default) marches fields shaped like fused
    TSDF targets, negative in observed free space, and finds the first
    - -> + crossing; `"sdf"` marches classic signed distances (+ outside).
    With n_fine_steps > 0 the coarse bracket is refined by a second march
    inside it before the secant steps; with `aabb` each ray's interval is
    clipped to the box (ray_aabb_clip).

    tsdf_fn: (B, N, 3) -> (B, N). origins, dirs: (B, R, 3).
    Returns depth (B, R) (0 where no crossing) and mask (B, R) bool."""
    if convention not in ("fusion", "sdf"):
        raise ValueError(f"convention must be 'fusion' or 'sdf', got {convention!r}")
    field = (lambda p: -tsdf_fn(p)) if convention == "fusion" else tsdf_fn
    B, R, _ = origins.shape
    device = origins.device
    if aabb is not None:
        t_near, t_far = ray_aabb_clip(origins, dirs, aabb[0], aabb[1], near, far)
        u = linspace(0.0, 1.0, n_steps, device)
        ts = t_near[..., None] + (t_far - t_near)[..., None] * u  # (B, R, S)
        pts = origins[:, :, None, :] + dirs[:, :, None, :] * ts[..., None]
    else:
        ts = linspace(near, far, n_steps, device)  # (S,)
        pts = origins[:, :, None, :] + dirs[:, :, None, :] * ts[None, None, :, None]
    vals = field(pts.reshape(B, R * n_steps, 3)).reshape(B, R, n_steps)
    t_lo, t_hi, f_lo, f_hi, any_cross = _first_crossing(vals, ts)

    if n_fine_steps > 0:
        S = n_fine_steps
        u = linspace(0.0, 1.0, S, device)  # includes the bracket's ends
        ts_f = t_lo[..., None] + (t_hi - t_lo)[..., None] * u
        pts_f = origins[:, :, None, :] + dirs[:, :, None, :] * ts_f[..., None]
        vals_f = field(pts_f.reshape(B, R * S, 3)).reshape(B, R, S)
        ft_lo, ft_hi, ff_lo, ff_hi, fine_cross = _first_crossing(vals_f, ts_f)
        t_lo = torch.where(fine_cross, ft_lo, t_lo)
        t_hi = torch.where(fine_cross, ft_hi, t_hi)
        f_lo = torch.where(fine_cross, ff_lo, f_lo)
        f_hi = torch.where(fine_cross, ff_hi, f_hi)

    for _ in range(n_secant_steps):
        t_mid = torch.minimum(torch.maximum(_secant(t_lo, f_lo, t_hi, f_hi), t_lo), t_hi)
        f_mid = field(origins + dirs * t_mid[..., None]).reshape(B, R)
        go_low = f_mid > 0
        t_lo = torch.where(go_low, t_mid, t_lo)
        f_lo = torch.where(go_low, f_mid, f_lo)
        t_hi = torch.where(go_low, t_hi, t_mid)
        f_hi = torch.where(go_low, f_hi, f_mid)
    depth = _secant(t_lo, f_lo, t_hi, f_hi)
    depth = torch.where(any_cross, depth, torch.zeros_like(depth))
    return depth, any_cross


class SurfaceRenderer:
    """Renderer over a decode function: decode_fn(xyz (B, N, 3)) -> dict
    with 'tsdf' (B, N, 1) and the feature keys (B, N, C) (the GenNerf
    decode contract).

    Defaults are the reference's: a 16-sample coarse march, an 8-sample
    fine bracket and 4 secant steps; decode_fn lookups chunked to
    `eval_chunk` points; images rendered in chunks of
    n_max_network_queries // n_steps rays. `tsdf_fn` ((B, N, 3) -> (B, N))
    replaces decode_fn for the march and secant lookups; the feature
    lookup at the surface always uses decode_fn. `aabb` = (box_min,
    box_max) clips each ray's march to the scene box."""

    def __init__(self, decode_fn, near: float = 0.05, far: float = 4.0, n_steps: int = 16,
                 n_secant_steps: int = 4, n_max_network_queries: int = 786432, tsdf_fn=None,
                 n_fine_steps: int = 8, eval_chunk: int = 32768, convention: str = "fusion",
                 aabb=None):
        self.decode_fn = decode_fn
        self.near = near
        self.far = far
        self.n_steps = n_steps
        self.n_secant_steps = n_secant_steps
        self.n_max_network_queries = n_max_network_queries
        self._tsdf_fast = tsdf_fn
        self.n_fine_steps = n_fine_steps
        self.eval_chunk = eval_chunk
        self.convention = convention
        self.aabb = None if aabb is None else tuple(
            torch.as_tensor(a, dtype=torch.float32) for a in aabb)

    def _tsdf(self, pts: torch.Tensor) -> torch.Tensor:
        if self._tsdf_fast is not None:
            return self._tsdf_fast(pts)
        c = self.eval_chunk
        if c <= 0 or pts.shape[1] <= c:
            return self.decode_fn(pts)["tsdf"][..., 0]
        return torch.cat([self.decode_fn(p)["tsdf"][..., 0] for p in torch.split(pts, c, dim=1)],
                         dim=1)

    def _march(self, h_idxs, w_idxs, intrinsics, pose):
        origins, dirs = pixels_to_rays(h_idxs.to(torch.float32), w_idxs.to(torch.float32),
                                       intrinsics, pose)
        aabb = None if self.aabb is None else tuple(a.to(origins.device) for a in self.aabb)
        depth, mask = ray_march_tsdf(self._tsdf, origins, dirs, self.near, self.far,
                                     self.n_steps, self.n_secant_steps, self.n_fine_steps,
                                     convention=self.convention, aabb=aabb)
        return depth, mask, origins + dirs * depth[..., None]

    def render_pixels(self, h_idxs, w_idxs, intrinsics, pose,
                      feature_key: str = "feat_sem") -> SurfaceRender:
        depth, mask, points = self._march(h_idxs, w_idxs, intrinsics, pose)
        feats = self.decode_fn(points)[feature_key]
        feats = torch.where(mask[..., None], feats, torch.zeros_like(feats))
        return SurfaceRender(depth=depth, points=points, mask=mask, features=feats)

    def _pixel_chunks(self, B: int, height: int, width: int, device):
        n = height * width
        hs, ws = torch.meshgrid(torch.arange(height, device=device),
                                torch.arange(width, device=device), indexing="ij")
        h = hs.reshape(1, -1).expand(B, n)
        w = ws.reshape(1, -1).expand(B, n)
        chunk = max(1, min(self.n_max_network_queries // max(self.n_steps, 1), n))
        return zip(torch.split(h, chunk, dim=1), torch.split(w, chunk, dim=1))

    def render_depth_image(self, intrinsics, pose, height: int, width: int) -> torch.Tensor:
        """A full (B, H, W) image of ray depths, in chunks of
        n_max_network_queries // n_steps rays. Only the march runs: no
        feature decode at the surface."""
        depth = [self._march(h, w, intrinsics, pose)[0]
                 for h, w in self._pixel_chunks(intrinsics.shape[0], height, width,
                                                intrinsics.device)]
        return torch.cat(depth, dim=1).reshape(-1, height, width)

    def render_feature_image(self, intrinsics, pose, height: int, width: int,
                             feature_key: str = "feat_sem"):
        """Full images of surface depth (B, H, W), hit mask (B, H, W) and
        features (B, H, W, C), features 0 where the ray found no surface.
        Same chunking as render_depth_image."""
        B = intrinsics.shape[0]
        parts = [self.render_pixels(h, w, intrinsics, pose, feature_key=feature_key)
                 for h, w in self._pixel_chunks(B, height, width, intrinsics.device)]
        depth = torch.cat([p.depth for p in parts], dim=1)
        mask = torch.cat([p.mask for p in parts], dim=1)
        feats = torch.cat([p.features for p in parts], dim=1)
        return (depth.reshape(B, height, width), mask.reshape(B, height, width),
                feats.reshape(B, height, width, -1))
