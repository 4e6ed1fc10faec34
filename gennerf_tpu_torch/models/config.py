"""Frozen model-config dataclasses (counterpart of gennerf_tpu/models/config.py).

Only the fields the predict, render and train paths of GenNerf (the
pointnet triplanes, the spatial feature volume, or both) read are kept; `config_from_dict` ignores every other key of an
experiment yaml (frustum sampling, the eikonal/gradient/distill weights,
...), exactly as the reference's does for bookkeeping keys. Defaults are
the reference's. Options the port does not implement yet are rejected by
`check_supported`, called at model construction, rather than computed
differently.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SpatialEncoderConfig:
    backbone: str = "resnet34"  # 'resnet18' | 'resnet34' | 'resnet50'
    # backbone npz (tools/port_backbone.py) grafted into the ResNet at init
    pretrained_path: Optional[str] = None
    num_layers: int = 4
    upsample_interp: str = "bilinear"
    feature_scale: float = 2.0
    use_first_pool: bool = True
    norm_type: str = "batch"
    blur_image: bool = True
    kernel_size: int = 41
    sigma: float = 10.0
    # 1x1 conv (with bias) after the stage concat; None keeps the concat
    out_channels: Optional[int] = None
    # encode this many frames at a time into the f32 volume (0: all at once)
    frame_chunk: int = 0


@dataclasses.dataclass(frozen=True)
class PointnetConfig:
    num_sparse_points: int = 512
    # uniform presample of each frame's unprojected cloud before FPS (0 = off)
    fps_presample: int = 16384
    sparsifier: str = "fps"  # 'fps' | 'voxel_hash' (not ported)
    # map world coords into ConvONet's ~[-0.5, 0.5] cube of the training volume
    normalize_coords: bool = False
    c_dim: int = 32
    dim: int = 3
    padding: float = 0.1
    hidden_dim: int = 32
    scatter_type: str = "max"
    plane_type: Tuple[str, ...] = ("xz", "xy", "yz")
    plane_resolution: int = 128
    n_blocks: int = 5
    unet: bool = True
    unet_depth: int = 5
    unet_merge_mode: str = "concat"
    unet_start_filts: int = 32
    sample_mode: str = "bilinear"


@dataclasses.dataclass(frozen=True)
class PlaneMergerConfig:
    strategy: str = "average"
    alpha: float = 0.1


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    use_spatial: bool = True
    spatial: SpatialEncoderConfig = SpatialEncoderConfig()
    use_pointnet: bool = True
    pointnet: PointnetConfig = PointnetConfig()
    plane_merger: PlaneMergerConfig = PlaneMergerConfig()
    use_auxiliary: bool = False


@dataclasses.dataclass(frozen=True)
class MlpConfig:
    d_out_sem: int = 32
    d_out_geo: int = 32
    n_blocks: int = 5
    d_hidden: int = 512
    combine_layer: int = 1000
    beta: float = 0.0
    use_spade: bool = False
    use_layer_norm: bool = False
    alpha: float = 1.0
    # post-tanh scale of the TSDF head (1.0 = reference-exact head math)
    head_smoothing: float = 1.0


@dataclasses.dataclass(frozen=True)
class CodeConfig:
    num_freqs: int = 2
    freq_factor: float = 0.5
    include_input: bool = True


@dataclasses.dataclass(frozen=True)
class RayConfig:
    """Ray-mode supervision: per sampled pixel the surface point, N
    stratified points over [d_min, depth + delta] and M Gaussian points
    of std sigma around the depth (iSDF)."""

    num_rays: int = 100
    N: int = 20
    M: int = 8
    d_min: float = 0.07
    delta: float = 0.1
    sigma: float = 0.1


@dataclasses.dataclass(frozen=True)
class TsdfLossConfig:
    weight: float = 1.0
    transform: str = "smooth_log"  # 'log' | 'smooth_log' | 'none'
    shift: float = 20.0
    smoothness: float = 8.0


@dataclasses.dataclass(frozen=True)
class IsdfLossConfig:
    weight: float = 1.0
    free_space_factor: float = 5.0
    trunc_weight: float = 5.0


@dataclasses.dataclass(frozen=True)
class FeatureLossConfig:
    weight: float = 0.1


@dataclasses.dataclass(frozen=True)
class LossConfig:
    use_tsdf: bool = True
    tsdf: TsdfLossConfig = TsdfLossConfig()
    use_isdf: bool = False
    isdf: IsdfLossConfig = IsdfLossConfig()
    use_feature: bool = False
    feature: FeatureLossConfig = FeatureLossConfig()
    # not ported (check_supported raises when set)
    use_eikonal: bool = False
    use_gradient: bool = False
    use_distill: bool = False


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    type: str = "Adam"
    lr: float = 0.001
    weight_decay: float = 0.0


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    type: str = "StepLR"  # 'StepLR' | 'None'
    step_size: int = 300
    gamma: float = 0.1


@dataclasses.dataclass(frozen=True)
class TeacherConfig:
    type: str = "none"  # only 'none' is ported


@dataclasses.dataclass(frozen=True)
class GenNerfConfig:
    voxel_size: float = 0.04
    voxel_dim_train: Tuple[int, int, int] = (160, 160, 64)
    voxel_dim_val: Tuple[int, int, int] = (256, 256, 96)
    voxel_dim_test: Tuple[int, int, int] = (416, 416, 128)
    # inference: clamp voxels no input frame touches to the fusion prior
    mask_unobserved: bool = True
    # inference: decode only the prior's near-surface band (needs mask_unobserved)
    sparse_band_decode: bool = False
    # recompute the spatial encoder (or each frame_chunk's encode and
    # backprojection) in backward instead of keeping its activations
    remat: bool = False
    sampling_mode: str = "ray"  # 'ray' ('frustum' is not ported)
    ray: RayConfig = RayConfig()
    encoder: EncoderConfig = EncoderConfig()
    mlp: MlpConfig = MlpConfig()
    use_code: bool = True
    code: CodeConfig = CodeConfig()
    loss: LossConfig = LossConfig()
    teacher: TeacherConfig = TeacherConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    scheduler: SchedulerConfig = SchedulerConfig()

    @property
    def encoder_latent(self) -> int:
        """The decoder's d_in: the spatial latent, then the plane channels."""
        from .spatial_encoder import spatial_latent_size

        enc = self.encoder
        d = 0
        if enc.use_spatial:
            s = enc.spatial
            d += s.out_channels or spatial_latent_size(s.backbone, s.num_layers)
        if enc.use_pointnet:
            d += enc.pointnet.c_dim
        return d


def check_supported(cfg: GenNerfConfig) -> None:
    """Raise NotImplementedError for every option this slice of the port
    does not implement (later slices lift these one by one)."""
    enc, p, m, loss = cfg.encoder, cfg.encoder.pointnet, cfg.mlp, cfg.loss
    s = enc.spatial
    unsupported = {
        "sampling_mode 'frustum'": cfg.sampling_mode != "ray",
        "loss.use_eikonal": loss.use_eikonal,
        "loss.use_gradient": loss.use_gradient,
        "loss.use_distill": loss.use_distill,
        "teacher.type other than 'none'": cfg.teacher.type != "none",
        "optimizer.type other than 'Adam'": cfg.optimizer.type != "Adam",
        "scheduler.type other than 'StepLR' or None":
            cfg.scheduler.type not in ("StepLR", "None", None),
        "encoder.use_auxiliary": enc.use_auxiliary,
        "neither encoder.use_spatial nor encoder.use_pointnet":
            not (enc.use_spatial or enc.use_pointnet),
        "spatial.norm_type other than 'batch'": enc.use_spatial and s.norm_type != "batch",
        "spatial.upsample_interp other than 'bilinear'":
            enc.use_spatial and s.upsample_interp != "bilinear",
        "pointnet.plane_type 'grid'": "grid" in p.plane_type,
        "pointnet.unet_merge_mode other than 'concat'": p.unet_merge_mode != "concat",
        "pointnet.sparsifier 'voxel_hash'": p.sparsifier != "fps",
        "plane_merger.strategy 'learn'": enc.plane_merger.strategy != "average",
        "mlp.use_spade": m.use_spade,
        "mlp.use_layer_norm": m.use_layer_norm,
    }
    bad = [name for name, on in unsupported.items() if on]
    if bad:
        raise NotImplementedError(
            f"gennerf_tpu_torch does not implement: {', '.join(bad)}"
        )


def config_from_dict(cls, d: dict):
    """Recursively build a frozen config dataclass from a (nested) dict,
    ignoring unknown keys and flattening `unet_kwargs` onto `unet_*` fields
    (reference gennerf_tpu/models/config.py:358-390)."""
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in dict(d).items():
        if key == "unet_kwargs" and isinstance(value, dict):
            for k2, v2 in value.items():
                name = f"unet_{k2}" if f"unet_{k2}" in fields else k2
                if name in fields:
                    kwargs[name] = _deep_tuple(v2)
            continue
        if key not in fields:
            if isinstance(value, dict):
                for k2, v2 in value.items():
                    name = f"{key}_{k2}"
                    if name in fields:
                        kwargs[name] = _deep_tuple(v2)
            continue
        f = fields[key]
        default = f.default if f.default is not dataclasses.MISSING else None
        if dataclasses.is_dataclass(default) and isinstance(value, dict):
            kwargs[key] = config_from_dict(type(default), value)
        else:
            kwargs[key] = _deep_tuple(value)
    return cls(**kwargs)


def _deep_tuple(x):
    if isinstance(x, list):
        return tuple(_deep_tuple(v) for v in x)
    return x
