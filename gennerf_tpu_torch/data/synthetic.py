"""Analytic RGB-D frames of a synthetic scene in numpy (the port's own copy
of `look_at_pose`, `render_scene`, `random_primitives` and `generate_scene`
from gennerf_tpu/data/synthetic.py: spheres, boxes, vertical capped
cylinders and room shells seen from inside, over a floor plane; the
'spheres', 'boxes', 'cylinders', 'mixed' and 'rooms' families), plus
`ring_frames`, which renders a ring of inward-looking
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
    of primitives (closest hit wins) over a floor plane: {"type": "sphere",
    "center", "radius"}, {"type": "box", "min", "max"}, {"type":
    "cylinder", "center": (x, y), "radius", "z0", "z1"} (vertical, capped)
    and {"type": "room", "min", "max"} (a box's inside, seen only by a
    camera within it). Rays are parameterized by camera z-depth, so the
    hit parameter IS the depth."""
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

    def hit_room(bmin, bmax):
        """The walls, ceiling and floor of a box seen from inside: the exit
        face; no hit for a camera outside the box."""
        bmin = np.asarray(bmin, np.float64)
        bmax = np.asarray(bmax, np.float64)
        if not (np.all(o > bmin) and np.all(o < bmax)):
            return np.full((H, W), np.inf), np.zeros((H, W, 3))
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / d
            t0 = (bmin - o) * inv
            t1 = (bmax - o) * inv
        t_far_ax = np.maximum(t0, t1)
        t_far = t_far_ax.min(-1)
        t = np.where(t_far > 1e-6, t_far, np.inf)
        axis = np.argmin(t_far_ax, axis=-1)
        n = np.zeros(d.shape)
        for a_i in range(3):
            sel = axis == a_i
            n[sel, a_i] = -np.sign(d[sel, a_i])  # inward, against the ray
        return t, n

    def hit_cylinder(center, radius, z0, z1):
        """A vertical cylinder around (x, y) = center from z0 to z1, capped."""
        cx, cy = float(center[0]), float(center[1])
        ocx, ocy = o[0] - cx, o[1] - cy
        a = d[..., 0] ** 2 + d[..., 1] ** 2
        b = d[..., 0] * ocx + d[..., 1] * ocy
        c = ocx**2 + ocy**2 - radius**2
        with np.errstate(invalid="ignore", divide="ignore"):
            disc = b**2 - a * c
            hit_side = (disc > 0) & (a > 1e-12)
            sqrt_disc = np.sqrt(np.where(hit_side, disc, 0.0))
            t_side = np.where(hit_side, (-b - sqrt_disc) / np.where(a > 1e-12, a, 1.0), np.inf)
        t_side = np.where(t_side > 1e-6, t_side, np.inf)
        with np.errstate(invalid="ignore"):  # inf * 0 is NaN: outside the band
            z_hit = o[2] + t_side * d[..., 2]
        t_side = np.where((z_hit >= z0) & (z_hit <= z1), t_side, np.inf)
        dz = d[..., 2]
        t_cap = np.full((H, W), np.inf)
        cap_sign = np.zeros((H, W))
        for zc in (z0, z1):
            with np.errstate(divide="ignore", invalid="ignore"):
                tc = np.where(np.abs(dz) > 1e-9, (zc - o[2]) / dz, np.inf)
            tc = np.where(tc > 1e-6, tc, np.inf)
            with np.errstate(invalid="ignore"):
                inside = ((o[0] + tc * d[..., 0] - cx) ** 2
                          + (o[1] + tc * d[..., 1] - cy) ** 2 <= radius**2)
            tc = np.where(inside, tc, np.inf)
            closer = tc < t_cap
            t_cap = np.where(closer, tc, t_cap)
            cap_sign = np.where(closer, -np.sign(dz), cap_sign)
        t = np.minimum(t_side, t_cap)
        with np.errstate(invalid="ignore"):
            pts = o + np.where(np.isfinite(t), t, 0.0)[..., None] * d
            n_side = np.stack([pts[..., 0] - cx, pts[..., 1] - cy, np.zeros((H, W))], -1)
            n_side /= np.maximum(np.linalg.norm(n_side, axis=-1, keepdims=True), 1e-9)
        n_cap = np.zeros((H, W, 3))
        n_cap[..., 2] = cap_sign
        return t, np.where((t_side <= t_cap)[..., None], n_side, n_cap)

    t_best = np.full((H, W), np.inf)
    n_best = np.zeros((H, W, 3))
    kind = np.full((H, W), -1, np.int64)
    for pi, prim in enumerate(primitives):
        if prim["type"] == "sphere":
            t_p, n_p = hit_sphere(prim["center"], prim["radius"])
        elif prim["type"] == "box":
            t_p, n_p = hit_box(prim["min"], prim["max"])
        elif prim["type"] == "cylinder":
            t_p, n_p = hit_cylinder(prim["center"], prim["radius"], prim["z0"], prim["z1"])
        elif prim["type"] == "room":
            t_p, n_p = hit_room(prim["min"], prim["max"])
        else:
            raise ValueError(prim["type"])
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
    """Random scene content of a geometry family, drawn from the numpy
    Generator `rng` in the reference's order: 'spheres', 'boxes' or
    'cylinders' resting on or near the floor within +-0.9 m of the origin
    in x and y; 'mixed' cycles sphere, box, cylinder; 'rooms' is a room
    shell (half-widths 1.15-1.5 m, 1.5-2 m high) with furniture cycling
    box, cylinder, sphere kept 0.55 m clear of the walls, whose cameras
    must stand inside the shell (generate_scene's room camera policy)."""
    if family == "rooms":
        hx, hy = (float(v) for v in rng.uniform(1.15, 1.5, 2))
        h = float(rng.uniform(1.5, 2.0))
        prims = [{"type": "room", "min": (-hx, -hy, 0.0), "max": (hx, hy, h)}]
        for i in range(int(rng.integers(n_min, n_max + 1))):
            cx = float(rng.uniform(-(hx - 0.55), hx - 0.55))
            cy = float(rng.uniform(-(hy - 0.55), hy - 0.55))
            kind = ("boxes", "cylinders", "spheres")[i % 3]
            if kind == "spheres":
                r = float(rng.uniform(0.15, 0.3))
                prims.append({"type": "sphere", "center": (cx, cy, r), "radius": r})
            elif kind == "cylinders":
                r = float(rng.uniform(0.12, 0.3))
                prims.append({"type": "cylinder", "center": (cx, cy), "radius": r, "z0": 0.0,
                              "z1": float(rng.uniform(0.3, 0.9))})
            else:
                sx, sy, sz = rng.uniform(0.2, 0.6, 3)
                prims.append({"type": "box", "min": (cx - sx / 2, cy - sy / 2, 0.0),
                              "max": (cx + sx / 2, cy + sy / 2, float(sz))})
        return prims
    if family not in ("spheres", "boxes", "cylinders", "mixed"):
        raise ValueError(f"unknown primitive family {family!r}")
    prims = []
    for i in range(int(rng.integers(n_min, n_max + 1))):
        cx, cy = rng.uniform(-0.9, 0.9, 2)
        kind = family if family != "mixed" else ("spheres", "boxes", "cylinders")[i % 3]
        if kind == "spheres":
            r = float(rng.uniform(0.2, 0.55))
            prims.append({"type": "sphere",
                          "center": (float(cx), float(cy), r + float(rng.uniform(0.0, 0.15))),
                          "radius": r})
        elif kind == "cylinders":
            r = float(rng.uniform(0.15, 0.45))
            h = float(rng.uniform(0.3, 1.0))
            prims.append({"type": "cylinder", "center": (float(cx), float(cy)), "radius": r,
                          "z0": 0.0, "z1": h})
        else:
            sx, sy, sz = rng.uniform(0.25, 0.9, 3)
            prims.append({"type": "box",
                          "min": (float(cx - sx / 2), float(cy - sy / 2), 0.0),
                          "max": (float(cx + sx / 2), float(cy + sy / 2), float(sz))})
    return prims


def room_camera(primitives, camera_radius: float, camera_height: float, target):
    """The reference generator's room camera policy: a room shell renders
    from inside only, so with a 'room' among the primitives the camera ring
    shrinks to 0.65 of the room's smaller half-width, the eye height to
    0.75 of the room's height above its floor, and the cameras aim at the
    room's centre 0.45 of its height up. Returns (camera_radius,
    camera_height, target)."""
    room = next((p for p in (primitives or []) if p["type"] == "room"), None)
    if room is None:
        return camera_radius, camera_height, target
    bmin = np.asarray(room["min"], np.float64)
    bmax = np.asarray(room["max"], np.float64)
    ctr = 0.5 * (bmin + bmax)
    half_xy = 0.5 * (bmax[:2] - bmin[:2])
    return (min(camera_radius, 0.65 * float(half_xy.min())),
            min(camera_height, float(bmin[2] + 0.75 * (bmax[2] - bmin[2]))),
            np.array([ctr[0], ctr[1], 0.45 * (bmax[2] - bmin[2])]))


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
        fusion = TSDFFusion(voxel_dim, voxel_size, (0.0, 0.0, 0.0), trunc_ratio=3, color=False)
        for P, depth in zip(frames[0], frames[2]):
            fusion.integrate(torch.from_numpy(P), torch.from_numpy(depth))
        vols.append(fusion.get_tsdf().tsdf_vol.numpy()[None])
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
    rendered depths and colours over the fixed box at origin (-1.6, -1.6,
    -0.16) m, 3.2 x 3.2 x 1.6 m, at each voxel size (cm) with a truncation
    of 3 voxels, and the coloured mesh of the smallest voxel size's volume.
    With a 'room' among the primitives the cameras follow `room_camera`.
    Returns the info.json path."""
    rng = np.random.default_rng(seed)
    scene_dir = os.path.join(out_dir, "scans", scene)
    color_dir = os.path.join(scene_dir, "color")
    depth_dir = os.path.join(scene_dir, "depth")
    os.makedirs(color_dir, exist_ok=True)
    os.makedirs(depth_dir, exist_ok=True)
    f = 0.6 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    target = np.asarray(sphere_center) if primitives is None else np.array([0.0, 0.0, 0.4])
    camera_radius, camera_height, target = room_camera(primitives, camera_radius, camera_height,
                                                       target)
    frames, depths, projections, colors = [], [], [], []
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
        colors.append(color.transpose(2, 0, 1).astype(np.float32))
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
        fusion = TSDFFusion(voxel_dim, vs, tuple(origin), trunc_ratio=3, color=True)
        for proj, depth, color in zip(projections, depths, colors):
            fusion.integrate(torch.from_numpy(proj), torch.from_numpy(depth),
                             torch.from_numpy(color))
        npz_path = os.path.join(scene_dir, f"tsdf_{vs_cm:02d}.npz")
        tsdf = fusion.get_tsdf()
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
