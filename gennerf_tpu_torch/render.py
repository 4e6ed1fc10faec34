"""Render a scene's decoded TSDF field at its own camera views and score the
depth against the measured depth (counterpart of
scripts/local/render_views.py): encode the frames, march the field through
the point-decode kernel (`make_point_tsdf_fn`; the f32 `GenNerf.decode` for
a scene the kernel does not take, `train.predict.uses_grid_decode`: a
feature volume, the 'grid' plane, SPADE, LayerNorm) inside the decode
volume's box, turn ray distance into z-depth, and run `eval_depth`.

    python -m gennerf_tpu_torch.render --config configs/experiment/seqs_multigeo_4cm.yaml \\
        --ckpt RUN --data-dir D [--split val.txt] --out out_dir [--num-views 4] [--features]
    python -m gennerf_tpu_torch.render --config configs/experiment/seqs_multigeo_4cm.yaml \\
        --params params.npz --frames frames.npz --out out_dir [--num-views 4] [--features]

The weights come from `--ckpt` (a checkpoint file, or a training run's
directory or its `checkpoints/`: the best monitored epoch there, else the
latest) or `--params` (an npz of the JAX model's `params` tree with
'/'-joined keys, utils/port_params.py, or a reference Lightning `.ckpt` or
state-dict `.pth`, utils/port_reference.py, as in the predict CLI);
without either they are a seeded random init. With `--data-dir`, every scene of the split (default:
data.datasets_test) comes through the data module's test loader and
`--num-views` of its frames are rendered; `--frames` holds one scene's
`projection` (T, 3, 4), `image` (T, 3, H, W), `depth` (T, H, W),
`intrinsics` (T, 3, 3) and camera2world `pose` (T, 4, 4). Writes one PNG
per view (predicted | measured z-depth; `{scene}_viewNNN.png` in split
mode), with `--features` one PNG of the surface features' first three
principal components, and `render_metrics.json` (per view, or per scene in
split mode, and the mean); prints the mean metrics as one JSON line. Runs
on the card unless `--device cpu` is given. The model computes in the
config's trainer.precision (bf16-mixed for the GenNerf configs under
`/trainer: tpu`); trailing `a.b=value` arguments override the config. It
renders a GenNerf field only: a VoxelNet config raises, as the JAX render
script exits.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from .device import resolve_device, set_reference_precision
from .eval.metrics import eval_depth
from .models.gen_nerf import GenNerf, SceneRepr
from .models.renderer import SurfaceRenderer, pixels_to_rays
from .train.predict import make_point_tsdf_fn, uses_grid_decode


def view_indices(num_frames: int, num_views: int) -> np.ndarray:
    """`num_views` frames spread evenly over the sequence, ends included."""
    return np.linspace(0, num_frames - 1, min(num_views, num_frames)).astype(int)


def feature_pca_rgb(mask: np.ndarray, feats: np.ndarray) -> np.ndarray:
    """(H, W) hit mask and (H, W, C) surface features -> (H, W, 3) uint8:
    the hit pixels' first three principal components, each scaled to
    [0, 255]; black where the ray found no surface or with < 3 hits."""
    rgb = np.zeros(mask.shape + (3,), np.uint8)
    hit = feats[mask]
    if hit.shape[0] >= 3:
        centered = hit - hit.mean(0)
        _, _, vt = np.linalg.svd(centered, full_matrices=False)
        proj3 = centered @ vt[:3].T
        lo, hi = proj3.min(0), proj3.max(0)
        rgb[mask] = ((proj3 - lo) / np.maximum(hi - lo, 1e-9) * 255).astype(np.uint8)
    return rgb


@torch.no_grad()
def render_encoded(model: GenNerf, repr_: SceneRepr, depth: torch.Tensor,
                   intrinsics: torch.Tensor, poses: torch.Tensor, tsdf_fn=None,
                   num_views: int = 4, near: float = 0.05, far: float = 5.0,
                   features: bool = False) -> dict:
    """Render an encoded scene at `num_views` of its frames. `tsdf_fn`
    marches the field (None: the f32 `GenNerf.decode`, chunked). Returns
    `views` (V,), ray distance `ray_depth` and z-depth `depth` (V, H, W)
    (0 where no surface), per-view `metrics` and their `mean`, and with
    `features` the per-view `feature_rgb` (V, H, W, 3) uint8."""
    cfg = model.cfg
    T, H, W = depth.shape
    vol_size = np.array(cfg.voxel_dim_test, np.float32) * cfg.voxel_size
    volume_cl = model.volume_features(repr_)  # once for every march step
    renderer = SurfaceRenderer(lambda pts: model.decode(repr_, pts, None, volume_cl),
                               near=near, far=far,
                               tsdf_fn=tsdf_fn, aabb=(np.zeros(3, np.float32), vol_size))
    device = depth.device
    hs, ws = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                            torch.arange(W, device=device, dtype=torch.float32), indexing="ij")
    views = view_indices(T, num_views)
    out = {"views": views, "ray_depth": [], "depth": [], "metrics": [], "feature_rgb": []}
    for vi in views:
        K, pose = intrinsics[vi][None], poses[vi][None]
        t_ray = renderer.render_depth_image(K, pose, H, W)[0]
        # ray distance -> z-depth: t * (unit_dir . camera forward)
        _, dirs = pixels_to_rays(hs.reshape(1, -1), ws.reshape(1, -1), K, pose)
        z = t_ray * (dirs[0] @ pose[0, :3, 2]).reshape(H, W)
        z_np = z.cpu().numpy()
        out["ray_depth"].append(t_ray.cpu().numpy())
        out["depth"].append(z_np)
        out["metrics"].append(eval_depth(z_np, depth[vi].cpu().numpy()))
        if features:
            _, fmask, feats = renderer.render_feature_image(K, pose, H, W)
            out["feature_rgb"].append(feature_pca_rgb(fmask[0].cpu().numpy(),
                                                      feats[0].cpu().numpy()))
    out["ray_depth"] = np.stack(out["ray_depth"])
    out["depth"] = np.stack(out["depth"])
    out["feature_rgb"] = np.stack(out["feature_rgb"]) if features else None
    out["mean"] = {k: float(np.mean([m[k] for m in out["metrics"]])) for k in out["metrics"][0]}
    return out


@torch.no_grad()
def render_views(model: GenNerf, projection, image, depth, intrinsics, poses,
                 num_views: int = 4, near: float = 0.05, far: float = 5.0,
                 use_kernel_path: bool = True, features: bool = False,
                 generator: Optional[torch.Generator] = None,
                 sel: Optional[torch.Tensor] = None,
                 start: Optional[torch.Tensor] = None) -> dict:
    """Encode one scene's T frames and render `num_views` of them (see
    render_encoded for the result), on the model's device.

    Args:
        projection: (T, 3, 4) world->image; image: (T, 3, H, W);
        depth: (T, H, W) measured z-depth; intrinsics: (T, 3, 3);
        poses: (T, 4, 4) camera2world.
        use_kernel_path: march through `make_point_tsdf_fn` (the point-decode
            kernel on the card); False, and every scene the kernel does
            not take (`uses_grid_decode`: a feature volume, the 'grid'
            plane, SPADE or LayerNorm, as in the reference), marches the
            f32 `GenNerf.decode`.
        generator, sel, start: the encoder's draws (see GenNerf.encode).
    """
    set_reference_precision()
    device = resolve_device(next(model.parameters()).device)
    projection, image, depth, intrinsics, poses = (
        torch.as_tensor(a, dtype=torch.float32).to(device)
        for a in (projection, image, depth, intrinsics, poses))
    # a feature volume is encoded on the test grid at origin 0, the box the march clips to
    repr_ = model.encode(projection[None], image[None], depth[None], generator, sel, start,
                         model.cfg.voxel_dim_test)
    use_kernel_path = use_kernel_path and uses_grid_decode(model)
    tsdf_fn = make_point_tsdf_fn(model, repr_) if use_kernel_path else None
    return render_encoded(model, repr_, depth, intrinsics, poses, tsdf_fn, num_views, near, far,
                          features)


def _write_views(out_dir: str, prefix: str, result: dict, depth: np.ndarray,
                 features: bool) -> None:
    """One depth panel PNG (predicted | measured, scaled by the measured
    maximum) per rendered view, and its feature PNG."""
    from .utils.image import write_png

    for i, vi in enumerate(result["views"]):
        gt = depth[vi]
        vmax = max(float(gt.max()), 1e-6)
        panel = np.concatenate([np.clip(result["depth"][i], 0, vmax), gt], axis=1)
        write_png(os.path.join(out_dir, f"{prefix}view{vi:03d}.png"),
                  (panel / vmax * 255).astype(np.uint8))
        if features:
            write_png(os.path.join(out_dir, f"{prefix}view{vi:03d}_feat.png"),
                      result["feature_rgb"][i])


def render_split(model: GenNerf, data_cfg: dict, out_dir: str, num_views: int = 4,
                 near: float = 0.05, far: float = 5.0, features: bool = False,
                 seed: int = 0) -> dict:
    """Render `num_views` views of every scene of the data config's test
    split (the test loader, one scene a batch); returns {scene: mean depth
    metrics} and writes the PNGs."""
    from .data.datamodule import ScannetDataModule

    loader = ScannetDataModule(dict(data_cfg, batch_size=1), seed=seed).test_dataloader()
    generator = torch.Generator().manual_seed(seed)
    per_scene = {}
    for batch in loader:
        scene = batch["scene"][0]
        frames = {k: np.asarray(batch[k][0]) for k in
                  ("projection", "image", "depth", "intrinsics", "pose")}
        result = render_views(model, frames["projection"], frames["image"], frames["depth"],
                              frames["intrinsics"], frames["pose"], num_views=num_views,
                              near=near, far=far, features=features, generator=generator)
        _write_views(out_dir, f"{scene}_", result, frames["depth"], features)
        per_scene[scene] = result["mean"]
        print(f"{scene}: {json.dumps(result['mean'])}", flush=True)
    return per_scene


def main(argv=None) -> dict:
    from .predict import build_model, load_weights
    from .utils.config import load_experiment_config

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True, help="configs/experiment/<name>.yaml")
    weights = parser.add_mutually_exclusive_group()
    weights.add_argument("--ckpt", help="checkpoint file, or a run or checkpoints/ directory "
                         "(its best monitored epoch, else the latest)")
    weights.add_argument("--params", help="npz of the JAX params tree ('/'-joined keys), or a "
                         "reference Lightning .ckpt or state-dict .pth")
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--frames", help="npz with projection, image, depth, intrinsics, pose")
    source.add_argument("--data-dir", help="dataset root: render the scenes of a split")
    parser.add_argument("--split", help="split list under --data-dir (default: data.datasets_test)")
    parser.add_argument("--out", required=True, help="output directory")
    parser.add_argument("--num-views", type=int, default=4)
    parser.add_argument("--near", type=float, default=0.05)
    parser.add_argument("--far", type=float, default=5.0)
    parser.add_argument("--features", action="store_true",
                        help="also write the surface features' PCA image per view")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("overrides", nargs="*", help="config overrides a.b.c=value")
    args = parser.parse_args(argv)

    overrides = [f"paths.data_dir={os.path.abspath(args.data_dir)}"] if args.data_dir else []
    cfg = load_experiment_config(args.config, "predict", overrides + args.overrides)
    if cfg["model"].get("type", "GenNerf") != "GenNerf":
        raise SystemExit("render drives the GenNerf field renderer only; "
                         f"the config's model is {cfg['model']['type']}")
    precision = str((cfg.get("trainer") or {}).get("precision", "32-true"))
    model = build_model(cfg["model"], args.device, args.seed, precision)
    load_weights(model, args.ckpt, args.params, precision)
    os.makedirs(args.out, exist_ok=True)
    if args.data_dir:
        data_cfg = dict(cfg["data"])
        if args.split:
            data_cfg["datasets_test"] = [args.split]
        per_scene = render_split(model, data_cfg, args.out, args.num_views, args.near, args.far,
                                 args.features, args.seed)
        mean = {k: float(np.mean([m[k] for m in per_scene.values()]))
                for k in next(iter(per_scene.values()))}
        record = {"per_scene": per_scene, "mean": mean}
    else:
        with np.load(args.frames) as f:
            frames = {k: f[k] for k in ("projection", "image", "depth", "intrinsics", "pose")}
        result = render_views(model, frames["projection"], frames["image"], frames["depth"],
                              frames["intrinsics"], frames["pose"], num_views=args.num_views,
                              near=args.near, far=args.far, features=args.features,
                              generator=torch.Generator().manual_seed(args.seed))
        _write_views(args.out, "", result, frames["depth"], args.features)
        mean = result["mean"]
        record = {"per_view": {int(vi): m for vi, m in zip(result["views"], result["metrics"])},
                  "mean": mean}
    with open(os.path.join(args.out, "render_metrics.json"), "w") as f:
        json.dump(record, f, indent=2)
    print(json.dumps({"renderer_depth_mean": mean}))
    return mean


if __name__ == "__main__":
    main()
