"""VoxelNet: the Atlas-style dense voxel TSDF model (counterpart of
gennerf_tpu/models/voxel_net.py).

encode: every frame's spatial-encoder features (`out_channels` =
backbone3d.channels[0]) backprojected and summed into the f32 volume and
its observation count, `frame_chunk` frames at a time, with `remat` as
checkpoint regions (models/gen_nerf.encode_feature_volume, shared with
GenNerf). refine: the count-normalized volume through the 3D
encoder-decoder (models/backbone3d.py) and the multi-scale TSDF heads
(models/heads.py), coarse scale first.

`dtype` is the compute dtype (bfloat16 under bf16-mixed): the spatial
encoder, the 3D convolutions and the head decoders compute in it;
parameters, the norms, the volume accumulator, the outputs and the losses
stay float32. Module names are the reference's (`spatial`, `backbone3d`,
`heads3d.heads.0.decoders.{i}`).

As the JAX VoxelNet, it always builds the spatial encoder and never a
pointnet: `encoder.use_pointnet` and `encoder.use_spatial: false` are
ignored there, and warn here. In training mode with backbone3d.drop > 0
the 3D backbone's dropout masks come from `dropout` (a DropoutDraws).
"""
from __future__ import annotations

import warnings
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..utils.spans import span
from .backbone3d import DropoutDraws, EncoderDecoder
from .config import VoxelNetConfig, check_supported_voxel_net
from .gen_nerf import encode_feature_volume, normalized_volume
from .heads import VoxelHeads
from .spatial_encoder import SpatialEncoder


class VolumeRepr(NamedTuple):
    volume: torch.Tensor  # (B, C, nx, ny, nz) summed frame features, f32
    valid: torch.Tensor   # (B, 1, nx, ny, nz) observation counts


class VoxelNet(nn.Module):
    def __init__(self, cfg: VoxelNetConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        check_supported_voxel_net(cfg)
        self.cfg, self.dtype = cfg, dtype
        s, b, h = cfg.encoder.spatial, cfg.backbone3d, cfg.heads
        ignored = [name for name, on in (("encoder.use_pointnet", cfg.encoder.use_pointnet),
                                         ("encoder.use_spatial false", not cfg.encoder.use_spatial))
                   if on]
        if ignored:
            warnings.warn(f"VoxelNet ignores {', '.join(ignored)}: it always encodes with the "
                          f"spatial encoder alone, as the JAX VoxelNet does")
        self.spatial = SpatialEncoder(
            s.backbone, s.num_layers, s.feature_scale, s.use_first_pool, s.blur_image,
            s.kernel_size, s.sigma, out_channels=b.channels[0], dtype=dtype,
            norm_type=s.norm_type, upsample_interp=s.upsample_interp)
        self.backbone3d = EncoderDecoder(b.channels, b.layers_down, b.layers, b.norm,
                                         b.conditional_skip, cfg.remat, dtype, b.drop)
        self.heads3d = VoxelHeads(
            b.channels, cfg.voxel_size, h.tsdf_multi_scale, h.tsdf_loss_weight,
            h.tsdf_label_smoothing, h.tsdf_loss_split, h.tsdf_loss_log_transform,
            h.tsdf_loss_log_transform_shift, h.tsdf_sparse_threshold, dtype)

    def encode(self, projection: torch.Tensor, image: torch.Tensor, voxel_dim,
               origin: Optional[torch.Tensor] = None) -> VolumeRepr:
        """(B, T, 3, 4) projections and (B, T, 3, H, W) images -> the summed
        feature volume at `origin` (default 0). In training mode the
        spatial encoder's running statistics move once per frame chunk."""
        cfg = self.cfg
        with span("gennerf.encode"):
            return VolumeRepr(*encode_feature_volume(
                self.spatial, projection, image, voxel_dim, cfg.voxel_size, origin,
                cfg.encoder.spatial.frame_chunk, cfg.remat))

    def refine(self, repr_: VolumeRepr, targets: Optional[Dict[str, torch.Tensor]] = None,
               dropout: Optional[DropoutDraws] = None
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Normalize the volume by its counts (0 where unseen), run the 3D
        backbone and the heads: ({vol_XX_tsdf: (B, 1, ...)}, {vol_XX_tsdf_loss})."""
        with span("gennerf.refine"):
            xs = self.backbone3d(normalized_volume(repr_.volume, repr_.valid), dropout)
            return self.heads3d(xs, targets)

    def forward(self, projection: torch.Tensor, image: torch.Tensor, voxel_dim,
                origin: Optional[torch.Tensor] = None,
                targets: Optional[Dict[str, torch.Tensor]] = None,
                dropout: Optional[DropoutDraws] = None):
        return self.refine(self.encode(projection, image, voxel_dim, origin), targets, dropout)
