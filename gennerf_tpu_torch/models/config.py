"""Frozen model-config dataclasses (counterpart of gennerf_tpu/models/config.py).

Only the fields the predict, render and train paths of GenNerf (the
pointnet triplanes, the spatial feature volume, the teacher's features,
or a mix) and of VoxelNet read are kept; `config_from_dict` ignores every
other key of an experiment yaml (a frustum's `N` and `M`, ...), exactly as
the reference's does for bookkeeping keys.
Defaults are the reference's. Options the JAX package refuses or cannot
run are rejected by `check_supported` / `check_supported_voxel_net`,
called at model construction, each message saying why; options the JAX
package ignores are accepted and warned about where the model is built.
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
    sparsifier: str = "fps"  # 'fps' | 'voxel_hash' (one random point per occupied cell)
    # map world coords into ConvONet's ~[-0.5, 0.5] cube of the training volume
    normalize_coords: bool = False
    c_dim: int = 32
    dim: int = 3
    padding: float = 0.1
    hidden_dim: int = 32
    scatter_type: str = "max"
    # any of 'xz', 'xy', 'yz' and 'grid' (ConvONet's grid_resolution^3 feature grid)
    plane_type: Tuple[str, ...] = ("xz", "xy", "yz")
    plane_resolution: int = 128
    grid_resolution: int = 32
    n_blocks: int = 5
    unet: bool = True
    # the grid's 3D U-Net (models/unet3d.py)
    unet3d: bool = False
    unet3d_f_maps: int = 32
    unet3d_num_levels: int = 3
    unet_depth: int = 5
    unet_merge_mode: str = "concat"  # 'concat' | 'add'
    unet_start_filts: int = 32
    sample_mode: str = "bilinear"


@dataclasses.dataclass(frozen=True)
class PlaneMergerConfig:
    strategy: str = "average"  # 'average' | 'learn' (a 1x1 conv, merger.conv)
    alpha: float = 0.1


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    use_spatial: bool = True
    spatial: SpatialEncoderConfig = SpatialEncoderConfig()
    use_pointnet: bool = True
    pointnet: PointnetConfig = PointnetConfig()
    plane_merger: PlaneMergerConfig = PlaneMergerConfig()
    # the teacher's 2D features backprojected into the feature volume
    use_auxiliary: bool = False
    auxiliary_dim: int = 0  # the teacher's channels when use_auxiliary


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
class FrustumConfig:
    """Frustum-mode supervision per frame: N_surf surface points, N_near
    surface points moved by sigma * noise and N_free points uniform in the
    frustum volume between d_min and d_max. An experiment's `N` and `M`
    keys are not fields: the reference ignores them too."""

    N_free: int = 384
    N_near: int = 128
    N_surf: int = 128
    sigma: float = 0.1
    d_min: float = 0.5
    d_max: float = 4.0


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
class EikonalLossConfig:
    weight: float = 0.25
    apply_distance: float = 0.1


@dataclasses.dataclass(frozen=True)
class GradientLossConfig:
    weight: float = 0.02


@dataclasses.dataclass(frozen=True)
class FeatureLossConfig:
    weight: float = 0.1


@dataclasses.dataclass(frozen=True)
class DistillLossConfig:
    """Distillation of feat_sem toward the 2D teacher's features. 'surface'
    supervises each ray's surface sample (ray mode only); 'render' marches
    `render_rays` rays a frame through the current field (no gradient) and
    supervises the first crossing, or with `gt_warmstart` the ground-truth
    depth's point where a ray has none."""

    weight: float = 1.0
    metric: str = "cosine"  # 'cosine' | 'l2'
    mode: str = "surface"  # 'surface' | 'render'
    gt_warmstart: bool = True
    render_rays: int = 32
    render_steps: int = 16
    render_fine: int = 8
    render_secant: int = 4
    render_near: float = 0.05
    render_far: float = 5.0


@dataclasses.dataclass(frozen=True)
class LossConfig:
    use_tsdf: bool = True
    tsdf: TsdfLossConfig = TsdfLossConfig()
    use_isdf: bool = False
    isdf: IsdfLossConfig = IsdfLossConfig()
    use_eikonal: bool = False
    eikonal: EikonalLossConfig = EikonalLossConfig()
    use_gradient: bool = False
    gradient: GradientLossConfig = GradientLossConfig()
    use_feature: bool = False
    feature: FeatureLossConfig = FeatureLossConfig()
    use_distill: bool = False
    distill: DistillLossConfig = DistillLossConfig()


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
    type: str = "none"  # 'none' | 'random_projection'
    feature_dim: int = 64
    patch: int = 8
    stride: int = 4
    seed: int = 0


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
    sampling_mode: str = "ray"  # 'ray' | 'frustum'
    ray: RayConfig = RayConfig()
    frustum: FrustumConfig = FrustumConfig()
    encoder: EncoderConfig = EncoderConfig()
    mlp: MlpConfig = MlpConfig()
    use_code: bool = True
    code: CodeConfig = CodeConfig()
    loss: LossConfig = LossConfig()
    teacher: TeacherConfig = TeacherConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    scheduler: SchedulerConfig = SchedulerConfig()

    @property
    def has_feature_volume(self) -> bool:
        """Whether an encoded scene carries a feature volume (the spatial
        encoder's or the teacher's): the one rule that builds it and that
        keeps such scenes off the grid- and point-decode kernels."""
        return self.encoder.use_spatial or self.encoder.use_auxiliary

    @property
    def encoder_latent(self) -> int:
        """The decoder's d_in: the spatial latent, the plane channels, then
        the teacher's (use_auxiliary)."""
        from .spatial_encoder import spatial_latent_size

        enc = self.encoder
        d = 0
        if enc.use_spatial:
            s = enc.spatial
            d += s.out_channels or spatial_latent_size(s.backbone, s.num_layers)
        if enc.use_pointnet:
            d += enc.pointnet.c_dim
        if enc.use_auxiliary:
            d += enc.auxiliary_dim
        return d


@dataclasses.dataclass(frozen=True)
class Backbone3dConfig:
    channels: Tuple[int, ...] = (32, 64, 128, 256)
    layers_down: Tuple[int, ...] = (1, 2, 3, 4)
    layers: Tuple[int, ...] = (3, 2, 1)
    norm: str = "BN"  # 'BN' | 'nnSyncBN' (alike on one card) | 'GN' | ''
    # dropout after each block's norms and each down stage's norm (training only)
    drop: float = 0.0
    conditional_skip: bool = False


@dataclasses.dataclass(frozen=True)
class HeadsConfig:
    use_tsdf: bool = True
    tsdf_multi_scale: bool = True
    tsdf_loss_weight: float = 1.0
    tsdf_label_smoothing: float = 1.05
    tsdf_loss_split: str = "pred"  # 'pred'; any other value computes 'none'
    tsdf_loss_log_transform: bool = True
    tsdf_loss_log_transform_shift: float = 1.0
    tsdf_sparse_threshold: Tuple[float, ...] = (0.99, 0.99, 0.99)


@dataclasses.dataclass(frozen=True)
class VoxelNetConfig:
    type: str = "VoxelNet"
    voxel_size: float = 0.04
    voxel_dim_train: Tuple[int, int, int] = (160, 160, 64)
    voxel_dim_val: Tuple[int, int, int] = (256, 256, 96)
    voxel_dim_test: Tuple[int, int, int] = (416, 416, 128)
    # inference: clamp voxels no input frame touches to the fusion prior
    mask_unobserved: bool = True
    # recompute the encode fold and every 3D residual block in backward
    remat: bool = False
    encoder: EncoderConfig = EncoderConfig(
        use_pointnet=False, spatial=SpatialEncoderConfig(blur_image=False))
    backbone3d: Backbone3dConfig = Backbone3dConfig()
    heads: HeadsConfig = HeadsConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    scheduler: SchedulerConfig = SchedulerConfig()

    @property
    def voxel_sizes(self) -> Tuple[int, ...]:
        """The head scales in cm, finest first (the ground truth keys
        vol_XX_tsdf the steps read)."""
        final = int(self.voxel_size * 100)
        return tuple(final * 2 ** i for i in range(len(self.backbone3d.layers_down) - 1))


def _raise_unsupported(unsupported: dict) -> None:
    bad = [name for name, on in unsupported.items() if on]
    if bad:
        raise NotImplementedError(
            f"gennerf_tpu_torch does not implement: {', '.join(bad)}"
        )


def check_supported_voxel_net(cfg: VoxelNetConfig) -> None:
    """Raise NotImplementedError for every VoxelNet option the JAX package
    cannot run either. 'BN' and 'nnSyncBN' are alike on one card (the JAX
    norm syncs only under a bound axis name); the options the JAX VoxelNet
    ignores (encoder.use_pointnet, encoder.use_spatial false, a spatial
    norm_type other than 'batch', a loss split other than 'pred') build and
    warn in models/voxel_net.py."""
    b = cfg.backbone3d
    _raise_unsupported({
        # the JAX heads then return no output and no loss: its train step's
        # sum({}) is the int 0, which jax.value_and_grad refuses (TypeError)
        "heads.use_tsdf false (no loss to train: the JAX train step fails too)":
            not cfg.heads.use_tsdf,
        "backbone3d.norm other than 'BN', 'nnSyncBN', 'GN' or '' (the JAX norm raises)":
            b.norm not in ("BN", "nnSyncBN", "GN", ""),
        "optimizer.type other than 'Adam' (the JAX make_optimizer raises)":
            cfg.optimizer.type != "Adam",
        "scheduler.type other than 'StepLR' or None (the JAX lr_for_epoch raises)":
            cfg.scheduler.type not in ("StepLR", "None", None),
    })


def check_supported(cfg: GenNerfConfig) -> None:
    """Raise NotImplementedError for every GenNerf option the JAX package
    refuses or cannot run, or whose weights are not in the repository."""
    enc, p, loss = cfg.encoder, cfg.encoder.pointnet, cfg.loss
    unsupported = {
        "sampling_mode other than 'ray' or 'frustum' (the JAX step raises too)":
            cfg.sampling_mode not in ("ray", "frustum"),
        "loss.use_gradient under sampling_mode 'frustum' (no normals: the JAX step fails too)":
            loss.use_gradient and cfg.sampling_mode != "ray",
        "teacher.type other than 'none' or 'random_projection' (the JAX make_teacher raises; "
        "no VLM weights are in the repository)":
            cfg.teacher.type not in ("none", "random_projection"),
        "optimizer.type other than 'Adam' (the JAX make_optimizer raises)":
            cfg.optimizer.type != "Adam",
        "scheduler.type other than 'StepLR' or None (the JAX lr_for_epoch raises)":
            cfg.scheduler.type not in ("StepLR", "None", None),
        "neither encoder.use_spatial nor encoder.use_pointnet (the JAX map_features then has "
        "no spatial or plane features to decode)": not (enc.use_spatial or enc.use_pointnet),
        "pointnet.plane_type other than 'xz', 'xy', 'yz' or 'grid' (the JAX "
        "normalize_coordinate raises)":
            not set(p.plane_type) <= {"xz", "xy", "yz", "grid"},
        "pointnet.unet_merge_mode other than 'concat' or 'add' (an unknown name, which the JAX "
        "UNet would take as 'add')":
            p.unet_merge_mode not in ("concat", "add"),
        "pointnet.sparsifier other than 'fps' or 'voxel_hash' (an unknown name, which the JAX "
        "encoder would take as 'fps')":
            p.sparsifier not in ("fps", "voxel_hash"),
        "plane_merger.strategy other than 'average' or 'learn' (the JAX merger raises)":
            enc.plane_merger.strategy not in ("average", "learn"),
    }
    _raise_unsupported(unsupported)


def config_from_dict(cls, d: dict):
    """Recursively build a frozen config dataclass from a (nested) dict,
    ignoring unknown keys and flattening `unet_kwargs` onto `unet_*` fields
    and any other nested dict onto prefixed fields (`heads.tsdf.multi_scale`
    -> `tsdf_multi_scale`; reference gennerf_tpu/models/config.py:358-390)."""
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
