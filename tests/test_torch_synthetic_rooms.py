"""The port's room and cylinder primitives and the 'cylinders', 'mixed' and
'rooms' families on the CPU against gennerf_tpu/data/synthetic.py: renders
(depth, and the colour that carries each hit's primitive and lambert
normal) of cylinders hit on the side and on each cap, of a room seen from
inside and from outside, of each family's draws; and generate_scene of a
room with the room camera policy.

Tolerances: the renders are the same float64 numpy on both sides, so
depths and colours are exact; the written scene's frames and cameras exact,
its ground truth within tests/test_torch_data.py's 4e-6 (the fusion's
coordinate rounding) and the colour volume within 1e-3 of 0-255, each on
all but 0.1% of the voxels: a voxel projecting onto a pixel border may
round to the neighbouring pixel in one package (1 of the 32,000 voxels
here, as the augmentation's nearest-tap ties in tests/test_torch_data.py).
"""
import json

import numpy as np
import pytest
import torch

from gennerf_tpu.data.synthetic import generate_scene as j_generate_scene
from gennerf_tpu.data.synthetic import random_primitives as j_random_primitives
from gennerf_tpu.data.synthetic import render_scene as j_render_scene
from gennerf_tpu_torch.data.synthetic import (
    generate_scene, look_at_pose, random_primitives, render_scene, room_camera,
)
from gennerf_tpu_torch.tsdf.tsdf import TSDF
from gennerf_tpu_torch.utils.image import read_png

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

H, W = 36, 48
K = np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2], [0, 0, 1]], np.float32)
CYLINDER = {"type": "cylinder", "center": (0.1, -0.2), "radius": 0.4, "z0": 0.0, "z1": 0.8}
ROOM = {"type": "room", "min": (-1.3, -1.2, 0.0), "max": (1.3, 1.2, 1.8)}


def _both(pose, prims):
    ours = render_scene(H, W, K, pose, primitives=prims)
    ref = j_render_scene(H, W, K, pose, primitives=prims)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    return ours


@pytest.mark.parametrize("eye", [(2.5, 0.3, 1.6), (0.1, -0.2, 2.5), (2.0, -1.5, 0.3)],
                         ids=["side_and_top_cap", "top_cap_only", "low_side"])
def test_cylinder_renders_match_jax(eye):
    depth, color = _both(look_at_pose(eye, (0.1, -0.2, 0.4)), [CYLINDER])
    hit = depth > 0
    assert hit.mean() > 0.05
    # the cylinder's hue (primitive 0) appears where it is hit
    assert (np.abs(color[hit].astype(int) - np.array([229, 76, 51])).sum(-1) < 200).any()


def test_room_from_inside_and_outside():
    inside = look_at_pose((0.4, 0.2, 1.2), (-1.0, -0.5, 0.7))
    depth, _ = _both(inside, [ROOM])
    assert (depth > 0).all() and depth.max() < 4.0  # every ray ends on a wall
    outside = look_at_pose((3.0, 0.0, 1.0), (0.0, 0.0, 0.8))
    depth, _ = _both(outside, [ROOM])
    far = depth[depth > 0]
    # a shell is one-sided: from outside only the floor plane is seen
    assert (depth == 0).any() and (far.size == 0 or far.min() > 1.0)


@pytest.mark.parametrize("family", ["cylinders", "mixed", "rooms"])
def test_family_scenes_render_match_jax(family):
    for seed in range(2):
        prims = random_primitives(np.random.default_rng(seed), family)
        assert prims == j_random_primitives(np.random.default_rng(seed), family)
        radius, height, target = room_camera(prims, 2.2, 1.3, np.array([0.0, 0.0, 0.4]))
        pose = look_at_pose((radius, 0.3, height), target)
        depth, _ = _both(pose, prims)
        assert (depth > 0).mean() > 0.3
        if family == "rooms":
            assert radius < 1.0 and (depth > 0).all()


def test_generate_scene_room_matches_jax(tmp_path):
    """A room scene with furniture (6 frames of 36x48 at 8 cm): the room
    camera policy puts every camera inside, so every pixel has depth; the
    same cameras, frames and ground truth as the JAX generator."""
    prims = random_primitives(np.random.default_rng(4), "rooms")
    args = dict(scene="scene_room", num_frames=6, H=H, W=W, voxel_sizes=(8,), primitives=prims,
                seed=2)
    ours = json.load(open(generate_scene(str(tmp_path / "t"), **args)))
    ref = json.load(open(j_generate_scene(str(tmp_path / "j"), **args)))
    room_min, room_max = np.array(prims[0]["min"]), np.array(prims[0]["max"])
    for fo, fr in zip(ours["frames"], ref["frames"]):
        assert fo["pose"] == fr["pose"] and fo["intrinsics"] == fr["intrinsics"]
        eye = np.array(fo["pose"])[:3, 3]
        assert (eye > room_min).all() and (eye < room_max).all()
        for key in ("file_name_image", "file_name_depth"):
            np.testing.assert_array_equal(read_png(fo[key]), read_png(fr[key]))
        assert (read_png(fo["file_name_depth"]) > 0).all()
    tv, jv = TSDF.load(ours["file_name_vol_08"]), TSDF.load(ref["file_name_vol_08"])
    assert (np.abs(tv.tsdf_vol.numpy() - jv.tsdf_vol.numpy()) > 4e-6).mean() <= 1e-3
    far = np.abs(tv.attribute_vols["color"].numpy() - jv.attribute_vols["color"].numpy())
    assert (far > 1e-3 * 255).mean() <= 1e-3
    assert (tv.tsdf_vol.numpy() < 0).any() and (np.abs(tv.tsdf_vol.numpy()) < 1).any()
