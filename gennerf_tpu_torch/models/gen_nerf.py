"""GenNerf (counterpart of gennerf_tpu/models/gen_nerf.py): the pointnet
triplanes, the spatial feature volume, or both.

encode: with the pointnet, unproject each frame's depth, presample each
frame's cloud uniformly, farthest-point sample it (the FPS kernel on the
card) and encode the accumulated sparse points into xz/xy/yz triplanes;
with the spatial encoder, run the ResNet encoder on every frame and sum
each frame's features, backprojected into the (nx, ny, nz) grid at
`origin`, into an f32 volume and its observation count. With
`spatial.frame_chunk` the frames go through the encoder and the
backprojection a chunk at a time; with `remat` each chunk (or, without
chunks, the encoder) is a `torch.utils.checkpoint` region whose running
BatchNorm statistics move once, in the forward pass.
decode: sample the triplanes bilinearly and the count-normalized volume
trilinearly at query points, concatenate the positional code and those
features, run ResnetFC and the TSDF head.

The JAX `key` becomes an explicit torch.Generator; the presample and FPS
start draws can also be passed in (`sel`, `start`) to replay another run's.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.coords import normalize_coordinate
from ..ops.interpolation import sample_plane_feature, trilinear_interpolation
from ..ops.projection import backproject_fold, get_3d_points
from ..ops.sampling import farthest_point_sample, uniform_presample
from .config import GenNerfConfig, check_supported
from .heads import TSDFHeadSimple
from .pointnet import FeaturePlaneMerger, LocalPoolPointnet
from .positional_encoding import positional_encoding, positional_encoding_dim
from .resnetfc import ResnetFC
from .spatial_encoder import SpatialEncoder


class SceneRepr(NamedTuple):
    """The scene encoding; None where the config has no such encoder."""

    planes: Optional[Dict[str, torch.Tensor]] = None  # plane -> (B, c_dim, reso, reso)
    volume: Optional[torch.Tensor] = None  # (B, C, nx, ny, nz) summed frame features
    valid: Optional[torch.Tensor] = None   # (B, 1, nx, ny, nz) observation counts


def _remat(fn: Callable, *args):
    """fn(*args, update_stats=...) as a checkpointed region: the forward
    call moves the running BatchNorm statistics, the recompute in backward
    normalizes with the same batch statistics and leaves them alone."""
    calls = []

    def run(*a):
        calls.append(None)
        return fn(*a, update_stats=len(calls) == 1)

    return checkpoint(run, *args, use_reentrant=False)


class GenNerf(nn.Module):
    def __init__(self, cfg: GenNerfConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        check_supported(cfg)
        if dtype != torch.float32:
            raise NotImplementedError("gennerf_tpu_torch runs float32 only (no bf16 precision yet)")
        self.cfg = cfg
        enc = cfg.encoder
        if enc.use_spatial:
            s = enc.spatial
            self.spatial = SpatialEncoder(
                s.backbone, s.num_layers, s.feature_scale, s.use_first_pool, s.blur_image,
                s.kernel_size, s.sigma, s.out_channels)
        if enc.use_pointnet:
            p = enc.pointnet
            self.pointnet = LocalPoolPointnet(
                c_dim=p.c_dim, dim=p.dim, hidden_dim=p.hidden_dim, scatter_type=p.scatter_type,
                use_unet=p.unet, unet_depth=p.unet_depth, unet_start_filts=p.unet_start_filts,
                plane_resolution=p.plane_resolution, plane_type=p.plane_type,
                padding=p.padding, n_blocks=p.n_blocks,
            )
            self.merger = FeaturePlaneMerger(enc.plane_merger.strategy, enc.plane_merger.alpha)
        d_code = (positional_encoding_dim(cfg.code.num_freqs, 3, cfg.code.include_input)
                  if cfg.use_code else 3)
        m = cfg.mlp
        self.mlp = ResnetFC(
            d_in=cfg.encoder_latent, d_out=m.d_out_geo + m.d_out_sem, n_blocks=m.n_blocks,
            d_latent=d_code, d_hidden=m.d_hidden, beta=m.beta,
            combine_layer=m.combine_layer, alpha=m.alpha,
        )
        self.head_geo = TSDFHeadSimple(m.d_out_geo, smoothing=m.head_smoothing)

    def plane_coords(self, xyz: torch.Tensor) -> torch.Tensor:
        """World points -> the frame the triplanes see: with
        pointnet.normalize_coords the training volume maps onto the
        ~[-0.5, 0.5] cube ConvONet expects, otherwise identity."""
        if not self.cfg.encoder.pointnet.normalize_coords:
            return xyz
        extent = torch.tensor(self.cfg.voxel_dim_train, dtype=torch.float32,
                              device=xyz.device) * self.cfg.voxel_size
        return (xyz - extent / 2.0) / extent.max()

    def encode(self, projection: torch.Tensor, image: torch.Tensor, depth: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               sel: Optional[torch.Tensor] = None,
               start: Optional[torch.Tensor] = None,
               voxel_dim=None, origin=None) -> SceneRepr:
        """Encode T posed RGB-D frames.

        Differentiable in the encoders' parameters; the sparse points
        (presample and FPS) are data, picked under no_grad. In training
        mode the spatial encoder's BatchNorm normalizes with batch
        statistics and moves its running ones (once per frame chunk).
        Callers that only infer wrap the call in torch.no_grad().

        Args:
            projection: (B, T, 3, 4) world->image.
            image: (B, T, 3, H, W).
            depth: (B, T, H, W).
            generator: source of the presample and FPS start draws.
            sel: (B*T, presample) injected presample indices.
            start: (B*T,) injected FPS start indices.
            voxel_dim: (nx, ny, nz) of the feature volume (spatial encoder only).
            origin: (3,) world position of the volume's voxel 0 (default 0).
        """
        enc = self.cfg.encoder
        volume = valid = planes = None
        if enc.use_spatial:
            volume, valid = self._encode_volume(projection, image, voxel_dim, origin)
        if enc.use_pointnet:
            planes = self._encode_planes(projection, depth, generator, sel, start)
        return SceneRepr(planes, volume, valid)

    def _encode_volume(self, projection, image, voxel_dim, origin):
        cfg = self.cfg
        if voxel_dim is None:
            raise ValueError("the spatial encoder needs the feature volume's voxel_dim")
        voxel_dim = tuple(int(d) for d in voxel_dim)
        if origin is None:
            origin = torch.zeros(3, dtype=torch.float32, device=projection.device)
        B, T = projection.shape[:2]
        hw = image.shape[-2:]
        remat = cfg.remat and torch.is_grad_enabled()
        chunk = cfg.encoder.spatial.frame_chunk

        def fold(imgs, proj, update_stats=True):
            return backproject_fold(self.spatial(imgs, update_stats), proj, hw, voxel_dim,
                                    cfg.voxel_size, origin)

        if not 0 < chunk < T:
            imgs = image.reshape(B * T, *image.shape[2:])
            feat = _remat(self.spatial, imgs) if remat else self.spatial(imgs)
            return backproject_fold(feat, projection, hw, voxel_dim, cfg.voxel_size, origin)
        volume = valid = None
        for t0 in range(0, T, chunk):
            t1 = min(t0 + chunk, T)
            imgs = image[:, t0:t1].reshape(B * (t1 - t0), *image.shape[2:])
            vol, val = _remat(fold, imgs, projection[:, t0:t1]) if remat else fold(
                imgs, projection[:, t0:t1])
            volume = vol if volume is None else volume + vol
            valid = val if valid is None else valid + val
        return volume, valid

    def _encode_planes(self, projection, depth, generator, sel, start):
        B, T = projection.shape[:2]
        npoint = self.cfg.encoder.pointnet.num_sparse_points
        with torch.no_grad():
            xyz = get_3d_points(depth.reshape(B * T, *depth.shape[2:]),
                                projection.reshape(B * T, 3, 4)).reshape(B * T, -1, 3)
            # invalid (depth 0) pixels unproject to the camera center; FPS
            # never picks such duplicates twice
            xyz = uniform_presample(xyz, self.cfg.encoder.pointnet.fps_presample, generator, sel)
            sparse, _ = farthest_point_sample(xyz, npoint, generator, start)
        accum = sparse.reshape(B, T * npoint, 3)
        return self.pointnet(self.plane_coords(accum))

    def merge(self, new: SceneRepr, old: SceneRepr) -> SceneRepr:
        """Fold a new encode into a running one: volumes and counts add,
        planes merge."""
        def add(a, b):
            return a if b is None else b if a is None else a + b

        planes = new.planes if old.planes is None else self.merger(new.planes, old.planes)
        return SceneRepr(planes, add(new.volume, old.volume), add(new.valid, old.valid))

    def volume_features(self, repr_: SceneRepr) -> Optional[torch.Tensor]:
        """The volume's mean feature per voxel (sum over count, 0 where no
        frame saw the voxel), channels-last (B, nx, ny, nz, C) and
        contiguous; None for a scene without a volume. A caller decoding
        one scene in many chunks computes it once and passes it on."""
        if repr_.volume is None:
            return None
        vol = repr_.volume / repr_.valid.clamp_min(1e-12)
        vol = torch.where(repr_.valid > 0, vol, torch.zeros((), dtype=vol.dtype, device=vol.device))
        return vol.permute(0, 2, 3, 4, 1).contiguous()

    def map_features(self, repr_: SceneRepr, xyz: torch.Tensor, origin=None,
                     volume_cl: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, N, 3) world points -> (B, N, d_in): the summed triplane
        features, then the volume's mean feature (`volume_features`, or
        `volume_cl` when given) sampled trilinearly at `origin` (default 0)."""
        feats = []
        if repr_.planes is not None:
            p = self.cfg.encoder.pointnet
            xyz_pn = self.plane_coords(xyz)
            feat = 0.0
            for plane in ("xz", "xy", "yz"):
                if plane in repr_.planes:
                    coords = normalize_coordinate(xyz_pn, padding=p.padding, plane=plane)
                    feat = feat + sample_plane_feature(repr_.planes[plane], coords,
                                                       mode=p.sample_mode)
            feats.append(feat)
        if repr_.volume is not None:
            if origin is None:
                origin = torch.zeros(3, dtype=torch.float32, device=xyz.device)
            if volume_cl is None:
                volume_cl = self.volume_features(repr_)
            feats.append(trilinear_interpolation(volume_cl, xyz, origin, self.cfg.voxel_size))
        return feats[0] if len(feats) == 1 else torch.cat(feats, dim=-1)

    def decode(self, repr_: SceneRepr, xyz: torch.Tensor, origin=None,
               volume_cl: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Predict feat_geo, feat_sem and tsdf at (B, N, 3) world points;
        `origin` places the feature volume (see map_features)."""
        cfg = self.cfg
        B, N, _ = xyz.shape
        feat = self.map_features(repr_, xyz, origin, volume_cl)
        if cfg.use_code:
            code = positional_encoding(xyz.reshape(-1, 3), cfg.code.num_freqs,
                                       cfg.code.freq_factor, cfg.code.include_input)
            code = code.reshape(B, N, -1)
        else:
            code = xyz
        out = self.mlp(torch.cat([code, feat], dim=-1))
        d_geo = cfg.mlp.d_out_geo
        feat_geo = out[..., :d_geo]
        return {"feat_geo": feat_geo, "feat_sem": out[..., d_geo:],
                "tsdf": self.head_geo(feat_geo), "feat": feat}
