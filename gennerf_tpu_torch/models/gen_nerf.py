"""GenNerf, pointnet-only (counterpart of gennerf_tpu/models/gen_nerf.py).

encode: unproject each frame's depth, presample each frame's cloud
uniformly, farthest-point sample it (the FPS kernel on the card), and
encode the accumulated sparse points into xz/xy/yz triplanes.
decode: sample the triplanes bilinearly at query points, concatenate the
positional code, run ResnetFC and the TSDF head.

The JAX `key` becomes an explicit torch.Generator; the presample and FPS
start draws can also be passed in (`sel`, `start`) to replay another run's.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from ..ops.coords import normalize_coordinate
from ..ops.interpolation import sample_plane_feature
from ..ops.projection import get_3d_points
from ..ops.sampling import farthest_point_sample, uniform_presample
from .config import GenNerfConfig, check_supported
from .heads import TSDFHeadSimple
from .pointnet import FeaturePlaneMerger, LocalPoolPointnet
from .positional_encoding import positional_encoding, positional_encoding_dim
from .resnetfc import ResnetFC


class SceneRepr(NamedTuple):
    """The scene encoding: plane -> (B, c_dim, reso, reso)."""

    planes: Dict[str, torch.Tensor]


class GenNerf(nn.Module):
    def __init__(self, cfg: GenNerfConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        check_supported(cfg)
        if dtype != torch.float32:
            raise NotImplementedError("gennerf_tpu_torch runs float32 only (no bf16 precision yet)")
        self.cfg = cfg
        p = cfg.encoder.pointnet
        self.pointnet = LocalPoolPointnet(
            c_dim=p.c_dim, dim=p.dim, hidden_dim=p.hidden_dim, scatter_type=p.scatter_type,
            use_unet=p.unet, unet_depth=p.unet_depth, unet_start_filts=p.unet_start_filts,
            plane_resolution=p.plane_resolution, plane_type=p.plane_type, padding=p.padding,
            n_blocks=p.n_blocks,
        )
        self.merger = FeaturePlaneMerger(cfg.encoder.plane_merger.strategy,
                                         cfg.encoder.plane_merger.alpha)
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
               start: Optional[torch.Tensor] = None) -> SceneRepr:
        """Encode T posed RGB-D frames.

        Differentiable in the PointNet and UNet parameters; the sparse
        points (presample and FPS) are data, picked under no_grad. Callers
        that only infer wrap the call in torch.no_grad().

        Args:
            projection: (B, T, 3, 4) world->image.
            image: (B, T, 3, H, W) (unused by the pointnet-only encoder).
            depth: (B, T, H, W).
            generator: source of the presample and FPS start draws.
            sel: (B*T, presample) injected presample indices.
            start: (B*T,) injected FPS start indices.
        """
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
        return SceneRepr(self.pointnet(self.plane_coords(accum)))

    def merge(self, new: SceneRepr, old: SceneRepr) -> SceneRepr:
        """Fold a new encode into a running one."""
        return SceneRepr(self.merger(new.planes, old.planes))

    def map_features(self, repr_: SceneRepr, xyz: torch.Tensor) -> torch.Tensor:
        """(B, N, 3) world points -> (B, N, c_dim) summed triplane features."""
        p = self.cfg.encoder.pointnet
        xyz_pn = self.plane_coords(xyz)
        feat = 0.0
        for plane in ("xz", "xy", "yz"):
            if plane in repr_.planes:
                coords = normalize_coordinate(xyz_pn, padding=p.padding, plane=plane)
                feat = feat + sample_plane_feature(repr_.planes[plane], coords, mode=p.sample_mode)
        return feat

    def decode(self, repr_: SceneRepr, xyz: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Predict feat_geo, feat_sem and tsdf at (B, N, 3) world points."""
        cfg = self.cfg
        B, N, _ = xyz.shape
        feat = self.map_features(repr_, xyz)
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
