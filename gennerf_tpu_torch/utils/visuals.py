"""Shaded renders of meshes for the logs (the port's copy of
gennerf_tpu/utils/visuals.py): the host rasterizer of the port's own C++
library (utils/native.py) shades each face, with no GL stack.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .mesh import Mesh


def render_mesh(mesh: Mesh, intrinsics: np.ndarray, pose: np.ndarray, height: int, width: int,
                color: Tuple[float, float, float] = (0.75, 0.75, 0.75),
                light_dir: Tuple[float, float, float] = (0.4, 0.3, 0.85),
                ) -> Tuple[np.ndarray, np.ndarray]:
    """A lambert-shaded view of `mesh` through (3, 3) `intrinsics` and the
    camera-to-world (4, 4) `pose`: rgb (H, W, 3) uint8 on a white
    background and depth (H, W) float32."""
    from .native import rasterize_shaded

    if mesh.is_empty:
        return (np.full((height, width, 3), 255, np.uint8),
                np.zeros((height, width), np.float32))
    return rasterize_shaded(mesh.vertices, mesh.faces, intrinsics, pose, height, width,
                            color, light_dir)


def compute_camera_pose(mesh: Mesh, intrinsics: np.ndarray, width: int, height: int,
                        margin: float = 0.8) -> np.ndarray:
    """An overview camera looking down at the mesh's centre from a distance
    that frames its extent."""
    from ..data.synthetic import look_at_pose

    if mesh.is_empty:
        return look_at_pose([2.0, 2.0, 2.0], [0, 0, 0])
    lo, hi = mesh.bounds()
    center = (lo + hi) / 2
    extent = float(np.linalg.norm(hi - lo))
    fx = float(np.asarray(intrinsics)[0, 0])
    dist = margin * extent * fx / max(width, 1) + 0.5 * extent
    eye = center + np.array([0.6, 0.6, 0.8]) / np.linalg.norm([0.6, 0.6, 0.8]) * dist
    return look_at_pose(eye, center)


def render_comparison(mesh_pred: Mesh, mesh_trgt: Mesh, intrinsics: np.ndarray,
                      pose: np.ndarray, height: int, width: int) -> np.ndarray:
    """Target | prediction side by side, (H, 2W, 3) uint8."""
    rgb_t, _ = render_mesh(mesh_trgt, intrinsics, pose, height, width)
    rgb_p, _ = render_mesh(mesh_pred, intrinsics, pose, height, width)
    return np.concatenate([rgb_t, rgb_p], axis=1)
