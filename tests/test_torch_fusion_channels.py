"""The colour and label channels of the port's TSDF fusion on the CPU
against gennerf_tpu/tsdf/fusion.py and tsdf.py: `fuse_frames` with
use_color / use_label, `TSDFFusion(color=, label=)` and its `get_tsdf`,
the volumes through `TSDF.save` / `load`, and the semseg mesh coloured by
the NYU40 palette; `depth_to_world` against the JAX unprojection.

Frames: a ring of 6 rendered 24x32 views of a sphere and a box, each pixel
labelled by a function of its colour. Tolerances: the TSDF within 1e-6
and the weights exact on the grid at the origin (tests/test_torch_train.py
::test_fuse_frames), the TSDF within 4e-6 on a grid off it
(tests/test_torch_data.py's bound for the generator's grid); the colour sums and the fused colour within 1e-3 of
the 0-255 range (float32 sums of up to 6 colours, identical gathers);
labels exact; save/load bit for bit; the semseg mesh's faces and colours
equal, its vertices as tests/test_torch_data.py::test_writer_matches_jax
holds a fused volume's (a vertex lies at v_a / (v_a - v_b) along its edge,
so the volumes' difference moves it: at most 1% of the vertices by more
than 1e-5 voxel, none by more than 1e-3 voxel);
depth_to_world within 1e-5 m.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu.data.colormaps import NYU40_COLORMAP as J_NYU40
from gennerf_tpu.ops.projection import depth_to_world as j_depth_to_world
from gennerf_tpu.tsdf.fusion import TSDFFusion as JTSDFFusion
from gennerf_tpu.tsdf.fusion import fuse_frames as j_fuse_frames
from gennerf_tpu.tsdf.tsdf import TSDF as JTSDF
from gennerf_tpu_torch.data.colormaps import NYU40_COLORMAP
from gennerf_tpu_torch.data.synthetic import ring_frames
from gennerf_tpu_torch.ops.projection import depth_to_world
from gennerf_tpu_torch.tsdf.fusion import TSDFFusion, fuse_frames
from gennerf_tpu_torch.tsdf.tsdf import TSDF

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

VOXEL_DIM, VOXEL_SIZE = (24, 24, 14), 0.08
COLOR_TOL = 1e-3 * 255
PRIMITIVES = [{"type": "sphere", "center": (0.9, 1.0, 0.35), "radius": 0.35},
              {"type": "box", "min": (1.1, 0.5, 0.0), "max": (1.5, 0.9, 0.45)}]


@pytest.fixture(autouse=True)
def _f32_highest():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def frames():
    """projection (T, 3, 4), colour (T, 3, H, W) in 0-255, depth (T, H, W)
    and labels (T, H, W) int32 in 0-44 (some outside the palette)."""
    P, image, depth = ring_frames(6, 24, 32, (1.0, 0.9, 0.3), PRIMITIVES, camera_radius=1.8)
    color = np.round(image * 255).astype(np.float32)
    labels = (color.sum(1).astype(np.int64) % 45).astype(np.int32)
    return P, color, depth, labels


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("channels", [(True, False), (False, True), (True, True)],
                         ids=["color", "label", "both"])
def test_fuse_frames_channels_match_jax(frames, channels):
    use_color, use_label = channels
    P, color, depth, labels = frames
    ref = j_fuse_frames(VOXEL_DIM, VOXEL_SIZE, jnp.zeros(3), 3 * VOXEL_SIZE, jnp.asarray(P),
                        jnp.asarray(depth), jnp.asarray(color), jnp.asarray(labels),
                        use_color=use_color, use_label=use_label)
    ours = fuse_frames(VOXEL_DIM, VOXEL_SIZE, torch.zeros(3), 3 * VOXEL_SIZE, _t(P), _t(depth),
                       _t(color), _t(labels), use_color=use_color, use_label=use_label)
    np.testing.assert_allclose(ours.tsdf.numpy(), np.asarray(ref.tsdf), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ours.weight.numpy(), np.asarray(ref.weight))
    assert (ours.color is None) == (not use_color) and (ours.label is None) == (not use_label)
    if use_color:
        np.testing.assert_allclose(ours.color.numpy(), np.asarray(ref.color), rtol=0,
                                   atol=COLOR_TOL)
        assert float(ours.color.max()) > 255  # sums over several frames
    if use_label:
        assert ours.label.dtype == torch.int32
        np.testing.assert_array_equal(ours.label.numpy(), np.asarray(ref.label))
        assert (ours.label.numpy() == -1).any() and (ours.label.numpy() >= 0).any()


def _fusions(frames, color, label, give=True):
    """Both packages' TSDFFusion fed the frames (colour and labels given
    under `give`, else depth only)."""
    P, col, depth, labels = frames
    origin = (-0.2, -0.1, -0.16)
    ours = TSDFFusion(VOXEL_DIM, VOXEL_SIZE, origin, color=color, label=label)
    ref = JTSDFFusion(VOXEL_DIM, VOXEL_SIZE, origin, color=color, label=label)
    for t in range(len(P)):
        extra = (col[t], labels[t]) if give else (None, None)
        ours.integrate(_t(P[t]), _t(depth[t]), *(None if e is None else _t(e) for e in extra))
        ref.integrate(P[t], depth[t], *extra)
    return ours, ref


@pytest.mark.parametrize("label_name", ["instance", "semseg"])
def test_get_tsdf_save_load_match_jax(frames, tmp_path, label_name):
    """get_tsdf's volume, colour and label volumes (origin and voxel size
    too), TSDF.save's npz read by both loaders, and a fusion given no
    colours keeps a zero colour volume, as in JAX."""
    ours_f, ref_f = _fusions(frames, True, True)
    ours, ref = ours_f.get_tsdf(label_name), ref_f.get_tsdf(label_name)
    assert ours.voxel_size == ref.voxel_size
    np.testing.assert_allclose(ours.origin.numpy(), np.asarray(ref.origin), rtol=0, atol=0)
    np.testing.assert_allclose(ours.tsdf_vol.numpy(), np.asarray(ref.tsdf_vol), rtol=0, atol=4e-6)
    assert sorted(ours.attribute_vols) == sorted(ref.attribute_vols) == sorted(["color", label_name])
    np.testing.assert_allclose(ours.attribute_vols["color"].numpy(),
                               np.asarray(ref.attribute_vols["color"]), rtol=0, atol=COLOR_TOL)
    np.testing.assert_array_equal(ours.attribute_vols[label_name].numpy(),
                                  np.asarray(ref.attribute_vols[label_name]))
    path = str(tmp_path / "ours.npz")
    ours.save(path)
    with np.load(path) as data:
        assert sorted(data) == sorted(["origin", "voxel_size", "tsdf", "color", label_name])
    for loaded in (TSDF.load(path), JTSDF.load(path)):
        np.testing.assert_array_equal(np.asarray(loaded.tsdf_vol), ours.tsdf_vol.numpy())
        np.testing.assert_array_equal(np.asarray(loaded.attribute_vols["color"]),
                                      ours.attribute_vols["color"].numpy())
        # the reference loaders read labels only under the name 'instance'
        assert ("instance" in loaded.attribute_vols) == (label_name == "instance")
    depth_only, ref_depth_only = _fusions(frames, True, False, give=False)
    assert not depth_only.get_tsdf().attribute_vols["color"].any()
    assert not np.asarray(ref_depth_only.get_tsdf().attribute_vols["color"]).any()


def test_semseg_mesh_matches_jax(frames):
    """A label-fused volume's mesh coloured by 'semseg' through the NYU40
    palette, and the palette itself."""
    assert NYU40_COLORMAP == J_NYU40 and len(NYU40_COLORMAP) == 41
    ours_f, ref_f = _fusions(frames, False, True)
    ours, ref = ours_f.get_tsdf("semseg"), ref_f.get_tsdf("semseg")
    ours_mesh, ref_mesh = ours.get_mesh("semseg"), ref.get_mesh("semseg")
    assert len(ours_mesh.faces) > 100
    np.testing.assert_array_equal(ours_mesh.faces, ref_mesh.faces)
    moved = np.abs(ours_mesh.vertices - ref_mesh.vertices).max(axis=1) / VOXEL_SIZE
    assert (moved > 1e-5).mean() <= 1e-2 and moved.max() <= 1e-3
    np.testing.assert_array_equal(ours_mesh.vertex_colors, ref_mesh.vertex_colors)
    np.testing.assert_array_equal(ours_mesh.vertex_attributes["semseg"],
                                  ref_mesh.vertex_attributes["semseg"])
    palette = {tuple(c) for c in NYU40_COLORMAP}
    assert {tuple(c) for c in ours_mesh.vertex_colors} <= palette
    assert len({tuple(c) for c in ours_mesh.vertex_colors}) > 3


def test_depth_to_world_matches_jax(frames):
    P, _, depth, _ = frames
    for t in (0, 3):
        ours = depth_to_world(_t(P[t]), _t(depth[t]))
        ref = np.asarray(j_depth_to_world(jnp.asarray(P[t]), jnp.asarray(depth[t])))
        assert tuple(ours.shape) == ref.shape == (3, 24 * 32)
        valid = depth[t].reshape(-1) > 0
        np.testing.assert_allclose(ours.numpy()[:, valid], ref[:, valid], rtol=0, atol=1e-5)
