"""Analytic RGB-D frames of a synthetic scene in numpy (the port's own copy
of `look_at_pose`, `render_scene`, `random_primitives` and `generate_scene`
from gennerf_tpu/data/synthetic.py, for the sphere and box primitives over
a floor plane), plus `ring_frames`, which renders a ring of inward-looking
cameras for predict drives, and `training_batch`, which adds the ground-
truth volume, fused from the frames by the port's `tsdf.fusion`, for
training drives. `generate_scene` writes a scene to disk in the layout the
loaders read; as a command it writes the distillation experiments' scene
(configs/experiment/distill_*synthetic.yaml read scans/scene_synth0):

    python -m gennerf_tpu_torch.data.synthetic --out DIR
"""
from __future__ import annotations

import argparse
import json
import os
import tarfile
from typing import Dict, Tuple

import numpy as np
import torch

from ..tsdf.fusion import TSDFFusion
from ..tsdf.tsdf import TSDF
from ..utils.image import write_png


def look_at_pose(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """camera2world (4, 4) with +z forward, +y down (vision convention)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    if np.linalg.norm(right) < 1e-6:
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    pose = np.eye(4)
    pose[:3, 0] = right
    pose[:3, 1] = down
    pose[:3, 2] = fwd
    pose[:3, 3] = eye
    return pose.astype(np.float32)


def render_scene(H: int, W: int, intrinsics: np.ndarray, pose: np.ndarray,
                 sphere_center=(0.0, 0.0, 0.5), sphere_radius: float = 0.5,
                 floor_z: float = 0.0, max_depth: float = 10.0,
                 primitives=None) -> Tuple[np.ndarray, np.ndarray]:
    """z-depth (H, W) f32 meters (0 = no hit) and shaded RGB (H, W, 3) uint8
    of sphere/box primitives (closest hit wins) over a floor plane. Rays are
    parameterized by camera z-depth, so the hit parameter IS the depth."""
    fx, fy = float(intrinsics[0, 0]), float(intrinsics[1, 1])
    cx, cy = float(intrinsics[0, 2]), float(intrinsics[1, 2])
    us, vs = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    d_cam = np.stack([(us - cx) / fx, (vs - cy) / fy, np.ones_like(us)], -1)
    R = pose[:3, :3].astype(np.float64)
    o = pose[:3, 3].astype(np.float64)
    d = d_cam @ R.T
    if primitives is None:
        primitives = [{"type": "sphere", "center": sphere_center, "radius": sphere_radius}]

    def hit_sphere(center, radius):
        c = np.asarray(center, np.float64)
        oc = o - c
        a = (d**2).sum(-1)
        b = (d * oc).sum(-1)
        disc = b**2 - a * ((oc**2).sum() - radius**2)
        hit = disc > 0
        sqrt_disc = np.sqrt(np.where(hit, disc, 0.0))
        t = np.where(hit, (-b - sqrt_disc) / a, np.inf)
        t = np.where(t > 1e-6, t, np.inf)
        with np.errstate(invalid="ignore"):
            n = o + t[..., None] * d - c
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        return t, n

    def hit_box(bmin, bmax):
        bmin = np.asarray(bmin, np.float64)
        bmax = np.asarray(bmax, np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / d
            t0 = (bmin - o) * inv
            t1 = (bmax - o) * inv
        t_near_ax = np.minimum(t0, t1)
        t_near = t_near_ax.max(-1)
        t_far = np.maximum(t0, t1).min(-1)
        hit = (t_far > np.maximum(t_near, 1e-6)) & (t_near > 1e-6)
        t = np.where(hit, t_near, np.inf)
        axis = np.argmax(t_near_ax, axis=-1)
        n = np.zeros(d.shape)
        for a_i in range(3):
            sel = axis == a_i
            n[sel, a_i] = -np.sign(d[sel, a_i])
        return t, n

    t_best = np.full((H, W), np.inf)
    n_best = np.zeros((H, W, 3))
    kind = np.full((H, W), -1, np.int64)
    for pi, prim in enumerate(primitives):
        if prim["type"] == "sphere":
            t_p, n_p = hit_sphere(prim["center"], prim["radius"])
        elif prim["type"] == "box":
            t_p, n_p = hit_box(prim["min"], prim["max"])
        else:
            raise ValueError(f"primitive {prim['type']!r} is not ported")
        closer = t_p < t_best
        t_best = np.where(closer, t_p, t_best)
        n_best = np.where(closer[..., None], n_p, n_best)
        kind = np.where(closer, pi, kind)

    dz = d[..., 2]
    with np.errstate(divide="ignore"):
        t_f = np.where(np.abs(dz) > 1e-9, (floor_z - o[2]) / dz, np.inf)
    t_f = np.where(t_f > 1e-6, t_f, np.inf)
    t = np.minimum(t_best, t_f)
    prim_closer = t_best <= t_f
    valid = np.isfinite(t) & (t <= max_depth)
    depth = np.where(valid, t, 0.0).astype(np.float32)

    with np.errstate(invalid="ignore", over="ignore"):
        pts = o + np.where(np.isfinite(t), t, 0.0)[..., None] * d
        light = np.array([0.4, 0.3, 0.85])
        light /= np.linalg.norm(light)
        lambert = np.clip((n_best * light).sum(-1), 0.15, 1.0)
        checker = ((np.floor(pts[..., 0] * 2) + np.floor(pts[..., 1] * 2)) % 2).astype(np.float64)
    hues = np.array([[0.9, 0.3, 0.2], [0.2, 0.7, 0.9], [0.8, 0.8, 0.2], [0.5, 0.3, 0.8]])
    prim_rgb = hues[np.maximum(kind, 0) % len(hues)] * lambert[..., None]
    floor_rgb = np.stack([0.3 + 0.4 * checker, 0.5 + 0.3 * checker, 0.4 + 0.2 * checker], -1)
    color = np.where(prim_closer[..., None], prim_rgb, floor_rgb)
    color = np.where(valid[..., None], color, 0.0)
    return depth, (color * 255).astype(np.uint8)


def ring_frames(num_frames: int, H: int, W: int, center, primitives,
                camera_radius: float = 2.2, camera_height: float = 1.3, seed: int = 0,
                cameras: bool = False, floor_z: float = 0.0):
    """Render `num_frames` cameras on a ring around `center` looking at it,
    `camera_height` above it, over a floor plane at height `floor_z`.

    Returns projection (T, 3, 4) f32 world->image (K @ inv(pose)[:3]),
    image (T, 3, H, W) f32 in [0, 1], depth (T, H, W) f32 meters, and with
    `cameras` also intrinsics (T, 3, 3) and camera2world poses (T, 4, 4),
    both f32."""
    rng = np.random.default_rng(seed)
    center = np.asarray(center, np.float64)
    f = 0.6 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    projections, images, depths, poses = [], [], [], []
    for i in range(num_frames):
        ang = 2 * np.pi * i / num_frames + 0.01 * rng.standard_normal()
        eye = center + np.array([camera_radius * np.cos(ang), camera_radius * np.sin(ang),
                                 camera_height + 0.05 * rng.standard_normal()])
        pose = look_at_pose(eye, center)
        depth, color = render_scene(H, W, K, pose, floor_z=floor_z, primitives=primitives)
        projections.append((K @ np.linalg.inv(pose)[:3]).astype(np.float32))
        images.append(color.transpose(2, 0, 1).astype(np.float32) / 255.0)
        depths.append(depth)
        poses.append(pose)
    frames = (np.stack(projections), np.stack(images), np.stack(depths))
    if cameras:
        frames += (np.repeat(K[None], num_frames, axis=0), np.stack(poses))
    return frames


def random_primitives(rng, family: str = "spheres", n_min: int = 1, n_max: int = 3):
    """Random spheres ('spheres') or boxes ('boxes') resting on or near the
    floor within +-0.9 m of the origin in x and y, drawn from the numpy
    Generator `rng` in the reference's order. The reference's 'cylinders',
    'mixed' and 'rooms' families need primitives this renderer lacks."""
    if family not in ("spheres", "boxes"):
        raise NotImplementedError(f"primitive family {family!r} is not ported")
    prims = []
    for _ in range(int(rng.integers(n_min, n_max + 1))):
        cx, cy = rng.uniform(-0.9, 0.9, 2)
        if family == "spheres":
            r = float(rng.uniform(0.2, 0.55))
            prims.append({"type": "sphere",
                          "center": (float(cx), float(cy), r + float(rng.uniform(0.0, 0.15))),
                          "radius": r})
        else:
            sx, sy, sz = rng.uniform(0.25, 0.9, 3)
            prims.append({"type": "box",
                          "min": (float(cx - sx / 2), float(cy - sy / 2), 0.0),
                          "max": (float(cx + sx / 2), float(cy + sy / 2), float(sz))})
    return prims


# the reference generator's volume below the floor (its origin z is -0.16 m)
FLOOR_HEIGHT = 0.16


def training_batch(B: int, T: int, H: int, W: int, voxel_dim, voxel_size: float,
                   seed: int = 0) -> Dict[str, np.ndarray]:
    """A training batch of B synthetic scenes, T ring frames each, with the
    ground truth fused from the frames.

    Scene b holds random_primitives of the family ('spheres', 'boxes')[b % 2].
    World coordinates put the training volume at origin 0: its xy center
    under the scene's center and the floor FLOOR_HEIGHT above its bottom,
    so the volume is the reference generator's box recentred, the crop an
    unaugmented loader takes. Cameras ring the scene as the reference
    generator's (radius 2.2 m, eye 1.3 m above the floor, aimed 0.4 m above
    it). The ground truth fuses the T depths at voxel_dim with a truncation
    of 3 voxels (as the reference generator's `TSDFFusion`).

    Returns numpy float32 arrays: projection (B, T, 3, 4), image
    (B, T, 3, H, W), depth (B, T, H, W), intrinsics (B, T, 3, 3), pose
    (B, T, 4, 4) camera->world and vol_XX_tsdf (B, 1, nx, ny, nz), XX the
    voxel size in cm."""
    rng = np.random.default_rng(seed)
    voxel_dim = tuple(int(d) for d in voxel_dim)
    extent = np.asarray(voxel_dim, np.float64) * voxel_size
    shift = np.array([extent[0] / 2, extent[1] / 2, FLOOR_HEIGHT])
    keys = ("projection", "image", "depth", "intrinsics", "pose")
    out = {k: [] for k in keys}
    vols = []
    for b in range(B):
        prims = []
        for p in random_primitives(rng, ("spheres", "boxes")[b % 2]):
            q = dict(p)
            for key in ("center", "min", "max"):
                if key in q:
                    q[key] = tuple(float(v) for v in np.asarray(q[key]) + shift)
            prims.append(q)
        frames = ring_frames(T, H, W, shift + np.array([0.0, 0.0, 0.4]), prims,
                             camera_radius=2.2, camera_height=0.9,
                             seed=int(rng.integers(2**31)), cameras=True,
                             floor_z=FLOOR_HEIGHT)
        for k, a in zip(keys, frames):
            out[k].append(a)
        fusion = TSDFFusion(voxel_dim, voxel_size, (0.0, 0.0, 0.0), trunc_ratio=3)
        for P, depth in zip(frames[0], frames[2]):
            fusion.integrate(torch.from_numpy(P), torch.from_numpy(depth))
        vols.append(fusion.get_tsdf().numpy()[None])
    batch = {k: np.stack(v).astype(np.float32) for k, v in out.items()}
    batch["vol_%02d_tsdf" % int(voxel_size * 100)] = np.stack(vols).astype(np.float32)
    return batch


def generate_scene(out_dir: str, scene: str = "scene_synth0", num_frames: int = 24,
                   H: int = 96, W: int = 128, voxel_sizes=(4, 8, 16), use_tar: bool = False,
                   camera_radius: float = 2.2, camera_height: float = 1.3,
                   sphere_center=(0.0, 0.0, 0.5), sphere_radius: float = 0.5, seed: int = 0,
                   primitives=None) -> str:
    """Write <out_dir>/scans/<scene>/{info.json, color/i.png, depth/i.png,
    tsdf_XX.npz, mesh_gt.ply} as the reference generator does, from the
    same seed stream: a ring of `num_frames` cameras around the scene, RGB
    and depth (millimetres, uint16) PNGs, the ground truth fused from the
    rendered depths over the fixed box at origin (-1.6, -1.6, -0.16) m,
    3.2 x 3.2 x 1.6 m, at each voxel size (cm) with a truncation of 3
    voxels, and the mesh of the smallest voxel size's volume. The ground
    truth holds the TSDF channel only (the port's fusion has no colour
    channel), so the mesh has no vertex colours. Returns the info.json
    path."""
    rng = np.random.default_rng(seed)
    scene_dir = os.path.join(out_dir, "scans", scene)
    color_dir = os.path.join(scene_dir, "color")
    depth_dir = os.path.join(scene_dir, "depth")
    os.makedirs(color_dir, exist_ok=True)
    os.makedirs(depth_dir, exist_ok=True)
    f = 0.6 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    target = np.asarray(sphere_center) if primitives is None else np.array([0.0, 0.0, 0.4])
    frames, depths, projections = [], [], []
    for i in range(num_frames):
        ang = 2 * np.pi * i / num_frames + 0.01 * rng.standard_normal()
        eye = np.array([camera_radius * np.cos(ang), camera_radius * np.sin(ang),
                        camera_height + 0.05 * rng.standard_normal()])
        pose = look_at_pose(eye, target)
        depth, color = render_scene(H, W, K, pose, sphere_center, sphere_radius,
                                    primitives=primitives)
        img_path = os.path.join(color_dir, f"{i}.png")
        dep_path = os.path.join(depth_dir, f"{i}.png")
        write_png(img_path, color)
        write_png(dep_path, (depth * 1000).astype(np.uint16))
        frames.append({"file_name_image": img_path, "file_name_depth": dep_path,
                       "intrinsics": K.tolist(), "pose": pose.tolist()})
        projections.append((K @ np.linalg.inv(pose)[:3]).astype(np.float32))
        depths.append(depth)
    if use_tar:
        for d, name in ((color_dir, "color"), (depth_dir, "depth")):
            with tarfile.open(os.path.join(d, name + ".tar"), "w") as tar:
                for i in range(num_frames):
                    tar.add(os.path.join(d, f"{i}.png"), arcname=f"{i}.png")

    origin = np.array([-1.6, -1.6, -0.16], np.float32)
    extent = np.array([3.2, 3.2, 1.6], np.float32)
    info = {"dataset": "synthetic", "scene": scene, "path": scene_dir, "frames": frames}
    for vs_cm in voxel_sizes:
        vs = vs_cm / 100.0
        voxel_dim = tuple(int(round(e / vs)) for e in extent)
        fusion = TSDFFusion(voxel_dim, vs, tuple(origin), trunc_ratio=3)
        for proj, depth in zip(projections, depths):
            fusion.integrate(torch.from_numpy(proj), torch.from_numpy(depth))
        npz_path = os.path.join(scene_dir, f"tsdf_{vs_cm:02d}.npz")
        tsdf = TSDF(vs, torch.from_numpy(origin).reshape(1, 3), fusion.get_tsdf())
        tsdf.save(npz_path)
        info[f"file_name_vol_{vs_cm:02d}"] = npz_path
        if vs_cm == min(voxel_sizes):
            mesh_path = os.path.join(scene_dir, "mesh_gt.ply")
            tsdf.get_mesh().export(mesh_path)
            info["file_name_mesh_gt"] = mesh_path
    info_path = os.path.join(scene_dir, "info.json")
    with open(info_path, "w") as fjson:
        json.dump(info, fjson)
    return info_path


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description="write scene_synth0 (24 frames) under DIR/scans")
    parser.add_argument("--out", required=True)
    info = generate_scene(parser.parse_args(argv).out)
    print(info)
    return info


if __name__ == "__main__":
    main()
