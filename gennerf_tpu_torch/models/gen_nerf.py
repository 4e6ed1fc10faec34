"""GenNerf (counterpart of gennerf_tpu/models/gen_nerf.py): the pointnet
triplanes, the spatial feature volume, or both.

encode: with the pointnet, unproject each frame's depth, presample each
frame's cloud uniformly, farthest-point sample it (the FPS kernel on the
card) and encode the accumulated sparse points into xz/xy/yz triplanes;
with the spatial encoder or `use_auxiliary` (the 2D teacher's features),
run those 2D featurizers on every frame, concatenate their channels
(spatial first) and sum each frame's features, backprojected into the
(nx, ny, nz) grid at `origin`, into an f32 volume and its observation
count. With `spatial.frame_chunk` (spatial encoder only) the frames go
through the featurizers and the backprojection a chunk at a time; with
`remat` each chunk (or, without chunks, the featurizers) is a
`torch.utils.checkpoint` region whose running BatchNorm statistics move
once, in the forward pass.
decode: sample the triplanes bilinearly and the count-normalized volume
trilinearly at query points, concatenate the positional code and those
features, run ResnetFC and the TSDF head. decode_with_grad adds
d(tsdf)/d(xyz) for the gradient losses, by autograd with a graph (the
training step's backward is then a double backward through the gathers,
the positional code and ResnetFC).

Precision: the model computes in `dtype` where the JAX GenNerf does
(bf16-mixed: the ResNet, the pointnet, its UNet, ResnetFC and the head);
parameters, running statistics, the volume and its counts stay float32.
The planes come out in the compute dtype and are sampled with float32
weights, so the decoder's features are float32, as are its outputs but
the TSDF, which is in the compute dtype (the losses cast it).

The JAX `key` becomes an explicit torch.Generator; the presample and FPS
start draws can also be passed in (`sel`, `start`) to replay another run's.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.coords import normalize_3d_coordinate, normalize_coordinate
from ..ops.interpolation import sample_plane_feature, trilinear_interpolation
from ..ops.projection import backproject_fold, get_3d_points
from ..ops.sampling import farthest_point_sample, uniform_presample, voxel_hash_downsample
from .config import GenNerfConfig, check_supported, options_without_bf16
from .heads import TSDFHeadSimple
from .pointnet import FeaturePlaneMerger, LocalPoolPointnet
from .positional_encoding import positional_encoding, positional_encoding_dim
from .resnetfc import ResnetFC
from .spatial_encoder import SpatialEncoder
from .teacher import RandomProjectionTeacher


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


def encode_feature_volume(featurize: Callable, projection: torch.Tensor, image: torch.Tensor,
                          voxel_dim, voxel_size: float, origin=None, frame_chunk: int = 0,
                          remat: bool = False):
    """The 2D features of T frames, `featurize(images, update_stats=True)`
    (B*t, C, H', W') (the spatial encoder, or GenNerf's concatenation of its
    featurizers), backprojected and summed into the f32 (B, C, nx, ny, nz)
    volume and its (B, 1, ...) observation count at `origin` (default 0),
    `frame_chunk` frames at a time (0: all at once); with `remat` (and
    gradients on) each chunk's encode and backprojection, or without chunks
    the featurizer, is a checkpoint region."""
    if voxel_dim is None:
        raise ValueError("the feature volume needs its voxel_dim")
    voxel_dim = tuple(int(d) for d in voxel_dim)
    if origin is None:
        origin = torch.zeros(3, dtype=torch.float32, device=projection.device)
    B, T = projection.shape[:2]
    hw = image.shape[-2:]
    remat = remat and torch.is_grad_enabled()

    def fold(imgs, proj, update_stats=True):
        return backproject_fold(featurize(imgs, update_stats), proj, hw, voxel_dim, voxel_size,
                                origin)

    if not 0 < frame_chunk < T:
        imgs = image.reshape(B * T, *image.shape[2:])
        feat = _remat(featurize, imgs) if remat else featurize(imgs)
        return backproject_fold(feat, projection, hw, voxel_dim, voxel_size, origin)
    volume = valid = None
    for t0 in range(0, T, frame_chunk):
        t1 = min(t0 + frame_chunk, T)
        imgs = image[:, t0:t1].reshape(B * (t1 - t0), *image.shape[2:])
        vol, val = _remat(fold, imgs, projection[:, t0:t1]) if remat else fold(
            imgs, projection[:, t0:t1])
        volume = vol if volume is None else volume + vol
        valid = val if valid is None else valid + val
    return volume, valid


def normalized_volume(volume: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The summed volume over its observation count, 0 where no frame saw
    the voxel."""
    vol = volume / valid.clamp_min(1e-12)
    return torch.where(valid > 0, vol, torch.zeros((), dtype=vol.dtype, device=vol.device))


class GenNerf(nn.Module):
    def __init__(self, cfg: GenNerfConfig, dtype: torch.dtype = torch.float32,
                 teacher: Optional[RandomProjectionTeacher] = None):
        """`teacher` (models/teacher.make_teacher of cfg.teacher) feeds the
        distillation targets and, with encoder.use_auxiliary, the feature
        volume; use_auxiliary without one raises ValueError."""
        super().__init__()
        check_supported(cfg)
        if dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(f"GenNerf computes in float32 or bfloat16, not {dtype}")
        enc = cfg.encoder
        f32_only = options_without_bf16(cfg)
        if dtype != torch.float32 and f32_only:
            raise NotImplementedError(f"gennerf_tpu_torch computes {', '.join(f32_only)} "
                                      f"in float32 only, not {dtype}")
        if enc.use_auxiliary and teacher is None:
            raise ValueError("encoder.use_auxiliary needs a teacher (make_teacher of a "
                             "config whose teacher.type is not 'none')")
        self.cfg, self.dtype, self.teacher = cfg, dtype, teacher
        if enc.use_spatial:
            s = enc.spatial
            self.spatial = SpatialEncoder(
                s.backbone, s.num_layers, s.feature_scale, s.use_first_pool, s.blur_image,
                s.kernel_size, s.sigma, s.out_channels, dtype=dtype)
        if enc.use_pointnet:
            p = enc.pointnet
            self.pointnet = LocalPoolPointnet(
                c_dim=p.c_dim, dim=p.dim, hidden_dim=p.hidden_dim, scatter_type=p.scatter_type,
                use_unet=p.unet, unet_depth=p.unet_depth, unet_merge_mode=p.unet_merge_mode,
                unet_start_filts=p.unet_start_filts, plane_resolution=p.plane_resolution,
                grid_resolution=p.grid_resolution, plane_type=p.plane_type, padding=p.padding,
                n_blocks=p.n_blocks, use_unet3d=p.unet3d, unet3d_f_maps=p.unet3d_f_maps,
                unet3d_num_levels=p.unet3d_num_levels, dtype=dtype,
            )
            self.merger = FeaturePlaneMerger(enc.plane_merger.strategy, enc.plane_merger.alpha,
                                             p.c_dim, dtype)
        d_code = (positional_encoding_dim(cfg.code.num_freqs, 3, cfg.code.include_input)
                  if cfg.use_code else 3)
        m = cfg.mlp
        self.mlp = ResnetFC(
            d_in=cfg.encoder_latent, d_out=m.d_out_geo + m.d_out_sem, n_blocks=m.n_blocks,
            d_latent=d_code, d_hidden=m.d_hidden, beta=m.beta,
            combine_layer=m.combine_layer, alpha=m.alpha, use_spade=m.use_spade,
            use_layer_norm=m.use_layer_norm, dtype=dtype,
        )
        self.head_geo = TSDFHeadSimple(m.d_out_geo, smoothing=m.head_smoothing, dtype=dtype)

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
            start: the sparsifier's injected draw: (B*T,) FPS start
                indices, or under `voxel_hash` (B*T, presample) uniform
                scores (`rnd`).
            voxel_dim: (nx, ny, nz) of the feature volume (spatial or auxiliary).
            origin: (3,) world position of the volume's voxel 0 (default 0).
        """
        enc = self.cfg.encoder
        volume = valid = planes = None
        if self.cfg.has_feature_volume:
            volume, valid = encode_feature_volume(
                self.features_2d, projection, image, voxel_dim, self.cfg.voxel_size, origin,
                enc.spatial.frame_chunk if enc.use_spatial else 0, self.cfg.remat)
        if enc.use_pointnet:
            planes = self._encode_planes(projection, depth, generator, sel, start)
        return SceneRepr(planes, volume, valid)

    def features_2d(self, images: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        """(N, 3, H, W) frames -> the feature volume's 2D features: the
        spatial encoder's channels, then the teacher's (use_auxiliary)."""
        enc = self.cfg.encoder
        feats = []
        if enc.use_spatial:
            feats.append(self.spatial(images, update_stats))
        if enc.use_auxiliary:
            feats.append(self.teacher(images))
        return feats[0] if len(feats) == 1 else torch.cat(feats, dim=1)

    def _encode_planes(self, projection, depth, generator, sel, start):
        B, T = projection.shape[:2]
        npoint = self.cfg.encoder.pointnet.num_sparse_points
        with torch.no_grad():
            xyz = get_3d_points(depth.reshape(B * T, *depth.shape[2:]),
                                projection.reshape(B * T, 3, 4)).reshape(B * T, -1, 3)
            # invalid (depth 0) pixels unproject to the camera center; FPS
            # never picks such duplicates twice
            xyz = uniform_presample(xyz, self.cfg.encoder.pointnet.fps_presample, generator, sel)
            if self.cfg.encoder.pointnet.sparsifier == "voxel_hash":
                sparse, _ = voxel_hash_downsample(xyz, npoint, generator, start)
            else:
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
        return normalized_volume(repr_.volume, repr_.valid).permute(0, 2, 3, 4, 1).contiguous()

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
            if "grid" in repr_.planes:
                # the feature grid, trilinear on the unit cube at origin 0, voxel 1/r
                grid = repr_.planes["grid"]
                feat = feat + trilinear_interpolation(
                    grid.permute(0, 2, 3, 4, 1), normalize_3d_coordinate(xyz_pn, p.padding),
                    torch.zeros(3, dtype=torch.float32, device=xyz.device), 1.0 / grid.shape[2])
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

    def decode_with_grad(self, repr_: SceneRepr, xyz: torch.Tensor, origin=None,
                         volume_cl: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """decode plus `grad`, d(tsdf)/d(xyz) (B, N, 3) in xyz's dtype: the
        vector-Jacobian product of a ones cotangent (in the TSDF's dtype)
        on the TSDF alone, as the reference's jax.vjp. Under autograd the
        gradient keeps its graph, so a loss on it trains the model; under
        no_grad it is computed all the same and returned detached."""
        training = torch.is_grad_enabled()
        with torch.enable_grad():
            p = xyz.detach().requires_grad_(True)
            out = self.decode(repr_, p, origin, volume_cl)
            tsdf = out["tsdf"]
            (grad,) = torch.autograd.grad(tsdf, p, torch.ones_like(tsdf), create_graph=training)
        out = dict(out, grad=grad)
        return out if training else {k: v.detach() for k, v in out.items()}
