"""Dense and arbitrary-point TSDF decoding (counterpart of
gennerf_tpu/train/predict.py).

`predict_tsdf_volume` makes one static choice from the config: a
triplane-only decoder the separable formulation supports goes to the
separable grid decode (the CUDA kernel on the card); every other config,
among them every config with a feature volume (the spatial encoder's or
the teacher's), any plane set other than exactly {xz, xy, yz} (the
'grid' plane) and a decoder with SPADE or LayerNorm, goes to the chunked
f32 per-point `decode_dense`. Both kernels take the head
bias folded into their last scalar, so trained weights reach them too.
`predict_tsdf_volume_sparse` decodes only the fusion prior's near-surface
band. `make_point_tsdf_fn` and `decode_dense_fused` feed the triplane
gather and the positional code of arbitrary points to the point-decode
kernel. There is no fall-through on runtime errors: a kernel that fails
raises, and an unsupported model raises NotImplementedError up front.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..models.gen_nerf import GenNerf, SceneRepr
from ..models.positional_encoding import positional_encoding
from ..ops.coords import grid_coordinates, normalize_coordinate
from ..ops.grid_decode import (
    extract_resnetfc_weights,
    grid_decode,
    grid_tables,
    supports_grid_decode,
)
from ..ops.point_decode import (
    fused_resnetfc_tsdf,
    fused_resnetfc_tsdf_plain,
    pack_point_weights,
    supports_fused_decode,
)
from ..ops.weight_slabs import pack_decode_weights
from ..tsdf.fusion import prior_classes


def dense_grid_points(voxel_dim, voxel_size: float, origin, device=None) -> torch.Tensor:
    """(nx*ny*nz, 3) query grid: linspace over voxel_size*voxel_dim per
    axis, endpoints inclusive, shifted by origin."""
    nx, ny, nz = (int(d) for d in voxel_dim)
    grid = grid_coordinates(nx, ny, nz, [voxel_size * d for d in (nx, ny, nz)], device)
    return grid.reshape(-1, 3) + torch.as_tensor(origin, dtype=torch.float32, device=device).reshape(1, 3)


@torch.no_grad()
def decode_dense(model: GenNerf, repr_: SceneRepr, points: torch.Tensor, origin=None,
                 chunk_size: int = 32768) -> torch.Tensor:
    """TSDF at (N, 3) points of one scene, chunk by chunk -> (N,) f32;
    `origin` places the feature volume (default 0), whose mean features are
    computed once for all chunks. A model computing in another dtype than
    float32 samples its planes and volume in that dtype (the counts stay
    as they are), as the reference's decode_dense does."""
    dt = model.dtype
    if dt != torch.float32:
        repr_ = SceneRepr(
            None if repr_.planes is None else {k: v.to(dt) for k, v in repr_.planes.items()},
            None if repr_.volume is None else repr_.volume.to(dt), repr_.valid)
    volume_cl = model.volume_features(repr_)
    out = [model.decode(repr_, chunk[None], origin, volume_cl)["tsdf"][0, :, 0]
           for chunk in torch.split(points, chunk_size)]
    return torch.cat(out).to(torch.float32)


def uses_grid_decode(model: GenNerf) -> bool:
    """The static dispatch of both decode kernels: the separable grid decode
    (and the render's point decode) for triplane-only scenes (no feature
    volume, exactly the xz, xy and yz planes, bilinear) of a supported
    decoder (no SPADE or LayerNorm); every other scene decodes in f32."""
    cfg = model.cfg
    return (
        supports_grid_decode(cfg)
        and cfg.encoder.use_pointnet
        and not cfg.has_feature_volume
        and set(cfg.encoder.pointnet.plane_type) == {"xz", "xy", "yz"}
        and cfg.encoder.pointnet.sample_mode == "bilinear"
    )


@torch.no_grad()
def decode_grid(model: GenNerf, repr_: SceneRepr, voxel_dim, voxel_size: float,
                origin) -> torch.Tensor:
    """Dense decode through the separable tables and the grid decode."""
    cfg = model.cfg
    planes = repr_.planes
    if planes["xz"].shape[0] != 1:
        raise ValueError("grid decode handles one scene at a time")
    weights = pack_decode_weights(extract_resnetfc_weights(
        model.mlp, model.head_geo, cfg.mlp.d_out_geo, cfg.mlp.head_smoothing), point=False)
    coord_center = coord_scale = None
    if cfg.encoder.pointnet.normalize_coords:
        extent = [d * cfg.voxel_size for d in cfg.voxel_dim_train]
        coord_center = tuple(e / 2.0 for e in extent)
        coord_scale = float(max(extent))
    tables = grid_tables(
        planes["xz"][0], planes["xy"][0], planes["yz"][0], origin, weights,
        voxel_dim=tuple(int(d) for d in voxel_dim), voxel_size=float(voxel_size),
        num_freqs=cfg.code.num_freqs, freq_factor=float(cfg.code.freq_factor),
        include_input=bool(cfg.code.include_input), padding=float(cfg.encoder.pointnet.padding),
        coord_center=coord_center, coord_scale=coord_scale,
    )
    return grid_decode(tables, weights)


@torch.no_grad()
def predict_tsdf_volume(model: GenNerf, repr_: SceneRepr, voxel_dim: Tuple[int, int, int],
                        voxel_size: float, origin, chunk_size: int = 32768) -> torch.Tensor:
    """Dense (nx, ny, nz) f32 TSDF volume of one scene on the grid at
    `origin` (which also places the feature volume)."""
    if uses_grid_decode(model):
        return decode_grid(model, repr_, voxel_dim, voxel_size, origin)
    device = next(model.parameters()).device
    pts = dense_grid_points(voxel_dim, voxel_size, origin, device)
    return decode_dense(model, repr_, pts, origin, chunk_size).reshape(
        tuple(int(d) for d in voxel_dim))


@torch.no_grad()
def predict_tsdf_volume_sparse(model: GenNerf, repr_: SceneRepr, voxel_dim, voxel_size: float,
                               origin, projections: torch.Tensor, depths: torch.Tensor,
                               trunc_ratio: float = 3.0, chunk_size: int = 32768) -> torch.Tensor:
    """Prior-first inference: decode only the near-surface band.

    Outside the band the fusion prior is a constant (-1 in observed free
    space, +1 elsewhere), so only the band voxels go through the chunked
    `decode_dense`; the result equals apply_fusion_prior of the dense
    gather decode. `projections` (T, 3, 4) and `depths` (T, H, W) are the
    encoded input frames."""
    nx, ny, nz = (int(d) for d in voxel_dim)
    device = depths.device
    origin = torch.as_tensor(origin, dtype=torch.float32, device=device).reshape(3)
    near, farfront = prior_classes((nx, ny, nz), float(voxel_size), origin,
                                   float(voxel_size) * trunc_ratio, projections, depths)
    one = torch.ones((), dtype=torch.float32, device=device)
    out = torch.where(farfront, -one, one)
    idx = torch.nonzero(near)[:, 0]
    if idx.numel():
        # flat index -> grid position as the reference computes it (numpy
        # f32: index * voxel_size*n/(n-1), plus origin)
        ijk = torch.stack([idx // (ny * nz), (idx // nz) % ny, idx % nz], dim=-1)
        step = torch.tensor([voxel_size * n / max(n - 1, 1) for n in (nx, ny, nz)],
                            dtype=torch.float32, device=device)
        pts = ijk.to(torch.float32) * step + origin
        out[idx] = decode_dense(model, repr_, pts, origin, chunk_size)
    return out.reshape(nx, ny, nz)


_PLANES = ("xz", "xy", "yz")


def triplane_gather_setup(model: GenNerf, planes: dict):
    """The fast gather's state: the three (B, C, r, r) planes flattened
    channels-last into one (B, 3*r*r, C) bf16 table (row = plane*r*r +
    y*r + x), the resolution, the padding and the plane-coordinate map."""
    cfg = model.cfg
    p = cfg.encoder.pointnet
    reso = planes["xz"].shape[-1]
    B, C = planes["xz"].shape[:2]
    flat = torch.cat([planes[k].permute(0, 2, 3, 1).reshape(B, reso * reso, C) for k in _PLANES],
                     dim=1).to(torch.bfloat16)
    center = scale = None
    if p.normalize_coords:
        extent = torch.tensor(cfg.voxel_dim_train, dtype=torch.float32,
                              device=flat.device) * cfg.voxel_size
        center, scale = extent / 2.0, extent.max()
    return flat, reso, float(p.padding), center, scale


def triplane_feat_fast(flat: torch.Tensor, reso: int, padding: float, center, scale,
                       pts: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) world points -> (B, N, C) summed triplane features from one
    gather of the 12 bilinear texels (align_corners=True, border clamp,
    normalize_coordinate's constants), bf16 texels weighted in f32."""
    B, N, _ = pts.shape
    xyz = pts if center is None else (pts - center) / scale
    idxs, wts = [], []
    for pi, plane in enumerate(_PLANES):
        uv = normalize_coordinate(xyz, padding, plane)
        ix = uv[..., 0] * (reso - 1)
        iy = uv[..., 1] * (reso - 1)
        x0 = torch.floor(ix)
        y0 = torch.floor(iy)
        wx = (ix - x0)[..., None]
        wy = (iy - y0)[..., None]
        x0i = x0.to(torch.int64)
        y0i = y0.to(torch.int64)
        x1i = (x0i + 1).clamp(0, reso - 1)
        y1i = (y0i + 1).clamp(0, reso - 1)
        x0i = x0i.clamp(0, reso - 1)
        y0i = y0i.clamp(0, reso - 1)
        base = pi * reso * reso
        idxs.append(torch.stack([base + y0i * reso + x0i, base + y0i * reso + x1i,
                                 base + y1i * reso + x0i, base + y1i * reso + x1i], dim=1))
        w = torch.cat([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy], dim=-1)
        wts.append(w.permute(0, 2, 1))  # (B, 4, N)
    idx = torch.cat(idxs, dim=1).reshape(B, 12 * N, 1)
    w = torch.cat(wts, dim=1)  # (B, 12, N)
    C = flat.shape[-1]
    vals = torch.gather(flat, 1, idx.expand(B, 12 * N, C)).reshape(B, 12, N, C)
    return (vals.to(torch.float32) * w[..., None]).sum(dim=1)


def _point_decode_setup(model: GenNerf) -> dict:
    """The static gates of the point-decode paths and the packed weights."""
    cfg = model.cfg
    if not supports_fused_decode(cfg):
        raise NotImplementedError("unsupported decoder config")
    return pack_point_weights(extract_resnetfc_weights(model.mlp, model.head_geo,
                                                       cfg.mlp.d_out_geo, cfg.mlp.head_smoothing))


def make_point_tsdf_fn(model: GenNerf, repr_: SceneRepr, plain: bool = False):
    """Forward-only TSDF at arbitrary points: the bf16 triplane gather and
    the positional code (torch ops) feeding one point-decode launch per
    call. Returns tsdf_fn(pts (B, N, 3)) -> (B, N) f32.

    `plain=True` runs the kernel's plain bf16-feed version on any device
    (the reference the kernel's march is held against). Raises
    NotImplementedError for an unsupported decoder, a non-triplane or
    non-bilinear scene, a scene with a feature volume, or a decoder latent
    other than the plane channels."""
    cfg = model.cfg
    planes = repr_.planes
    weights = _point_decode_setup(model)
    if repr_.volume is not None or planes is None:
        raise NotImplementedError("fused point decode supports triplane-only scenes")
    if set(planes) != set(_PLANES) or cfg.encoder.pointnet.sample_mode != "bilinear":
        raise NotImplementedError("fused point decode supports bilinear triplane-only scenes")
    if weights["w_in"].shape[0] != planes["xz"].shape[1]:
        raise NotImplementedError("decoder latent != triplane channels")
    setup = triplane_gather_setup(model, planes)
    code_cfg = cfg.code
    decode = fused_resnetfc_tsdf_plain if plain else fused_resnetfc_tsdf

    def tsdf_fn(pts: torch.Tensor) -> torch.Tensor:
        B, N, _ = pts.shape
        feat = triplane_feat_fast(*setup, pts)
        code = positional_encoding(pts.reshape(-1, 3), code_cfg.num_freqs, code_cfg.freq_factor,
                                   code_cfg.include_input)
        return decode(feat.reshape(B * N, -1), code, weights).reshape(B, N)

    return tsdf_fn


@torch.no_grad()
def decode_dense_fused(model: GenNerf, repr_: SceneRepr, points: torch.Tensor, origin=None,
                       chunk: int = 1 << 20) -> torch.Tensor:
    """TSDF at (N, 3) points of one scene -> (N,) f32: the feature gather
    (`GenNerf.map_features`, the feature volume at `origin`) and the
    positional code in chunks of `chunk`
    points, then one point-decode launch over the whole set (the kernel on
    the card, its plain bf16-feed version on the CPU)."""
    device = points.device
    if device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"fused decode runs on CUDA or the CPU, not {device}")
    weights = _point_decode_setup(model)
    code_cfg = model.cfg.code
    volume_cl = model.volume_features(repr_)
    feats, codes = [], []
    for p in torch.split(points, chunk):
        feats.append(model.map_features(repr_, p[None], origin, volume_cl)[0])
        codes.append(positional_encoding(p, code_cfg.num_freqs, code_cfg.freq_factor,
                                         code_cfg.include_input))
    return fused_resnetfc_tsdf(torch.cat(feats), torch.cat(codes), weights)
