"""The port's meshing on the CPU against the JAX package: the host
library's marching cubes, `TSDF.get_mesh` and the PLY files of `Mesh`,
and the library's build rules.

The JAX side runs as its own tests run it: `gennerf_tpu.native` loads the
repo's tracked library. Tolerances:
- marching cubes: faces equal; vertices within 1e-5 voxel (the two
  libraries come from one source, built by possibly different compilers);
- get_mesh: faces, colours and instance labels equal, vertices within
  1e-5 voxel times the voxel size;
- PLY files: byte for byte.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu import native as jnative
from gennerf_tpu.tsdf.tsdf import TSDF as JTSDF
from gennerf_tpu.utils.mesh import Mesh as JMesh
from gennerf_tpu_torch.data.synthetic import ring_frames
from gennerf_tpu_torch.ops.kernels import build_dir
from gennerf_tpu_torch.tsdf.fusion import fuse_frames
from gennerf_tpu_torch.tsdf.tsdf import TSDF
from gennerf_tpu_torch.utils import native
from gennerf_tpu_torch.utils.mesh import Mesh

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VERT_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _fused_sphere():
    """A sphere fused from 6 ring views at 8 cm: both plateaus, the band
    and unobserved (+1 init) voxels."""
    prims = [{"type": "sphere", "center": (0.0, 0.0, 0.35), "radius": 0.35}]
    P, _, depth = ring_frames(6, 24, 32, (0.0, 0.0, 0.35), prims)
    origin = np.array([-0.8, -0.8, -0.16], np.float32)
    state = fuse_frames((20, 20, 12), 0.08, _t(origin), 0.24, _t(P), _t(depth))
    return state.tsdf.reshape(20, 20, 12).numpy()


def _smooth(rng):
    """Random noise smoothed by a separable box filter, in [-1, 1]."""
    vol = rng.standard_normal((18, 17, 15))
    for axis in range(3):
        vol = sum(np.roll(vol, s, axis) for s in (-2, -1, 0, 1, 2)) / 5
    return np.clip(vol / np.abs(vol).max(), -1, 1).astype(np.float32)


def _slab():
    vol = np.ones((9, 10, 11), np.float32)
    vol[:, 4, :] = -0.5  # one voxel thick
    return vol


VOLUMES = {
    "fused_sphere": _fused_sphere,
    "smooth": lambda: _smooth(np.random.default_rng(3)),
    "no_crossing": lambda: np.full((6, 7, 8), 0.5, np.float32),
    "slab": _slab,
}


@pytest.mark.parametrize("name", sorted(VOLUMES))
def test_marching_cubes_matches_jax(name):
    vol = VOLUMES[name]()
    verts, faces = native.marching_cubes(vol, 0.0)
    ref_verts, ref_faces = jnative.marching_cubes(vol, 0.0)
    assert verts.dtype == np.float32 and faces.dtype == np.int32
    assert verts.shape == ref_verts.shape and verts.shape[1] == 3
    np.testing.assert_array_equal(faces, ref_faces)
    np.testing.assert_allclose(verts, ref_verts, rtol=0, atol=VERT_TOL)
    assert (len(faces) == 0) == (name == "no_crossing")


@pytest.fixture(scope="module")
def jax_written(tmp_path_factory):
    """A fused sphere volume at origin (-0.8, -0.8, -0.16) and voxel size
    0.08 with a float 'color' and an integer 'instance' volume, written by
    the JAX TSDF.save."""
    vol = _fused_sphere()
    rng = np.random.default_rng(4)
    attrs = {"color": rng.uniform(-20, 280, (3,) + vol.shape).astype(np.float32),
             "instance": rng.integers(0, 7, vol.shape).astype(np.int32)}
    origin = np.array([[-0.8, -0.8, -0.16]], np.float32)
    path = str(tmp_path_factory.mktemp("jax_tsdf") / "scene.npz")
    JTSDF(0.08, jnp.asarray(origin), jnp.asarray(vol),
          {k: jnp.asarray(v) for k, v in attrs.items()}).save(path)
    return path


def _assert_meshes_equal(ours, ref, voxel_size):
    np.testing.assert_array_equal(ours.faces, ref.faces)
    np.testing.assert_allclose(ours.vertices, ref.vertices, rtol=0, atol=VERT_TOL * voxel_size)
    assert (ours.vertex_colors is None) == (ref.vertex_colors is None)
    if ref.vertex_colors is not None:
        np.testing.assert_array_equal(ours.vertex_colors, ref.vertex_colors)


@pytest.mark.parametrize("attribute", ["color", "instance"])
def test_get_mesh_matches_jax(jax_written, attribute):
    """Both packages mesh the JAX-written file: world vertices, faces, the
    colours read from the color volume (clipped to uint8) and the instance
    labels at the rounded voxel index."""
    ours = TSDF.load(jax_written).get_mesh(attribute)
    ref = JTSDF.load(jax_written).get_mesh(attribute)
    assert len(ours.faces) > 100
    _assert_meshes_equal(ours, ref, 0.08)
    np.testing.assert_array_equal(ours.vertex_attributes["instance"],
                                  ref.vertex_attributes["instance"])
    assert (ours.vertex_colors is not None) == (attribute == "color")


def test_get_mesh_empty_and_semseg(jax_written):
    """A volume that does not cross 0 (every voxel at -1 counts as outside)
    gives an empty mesh, as in JAX; colouring by 'semseg' takes the NYU40
    palette of a semseg volume's labels (labels outside it coloured 0) and
    leaves a volume without one uncoloured, as in JAX."""
    for value in (1.0, -1.0):
        vol = torch.full((5, 6, 7), value)
        ours = TSDF(0.04, torch.zeros(1, 3), vol).get_mesh()
        ref = JTSDF(0.04, jnp.zeros((1, 3)), jnp.asarray(vol.numpy())).get_mesh()
        assert ours.is_empty and ref.is_empty and ours.vertices.shape == (0, 3)
    ours, ref = TSDF.load(jax_written), JTSDF.load(jax_written)
    no_labels = ours.get_mesh("semseg")
    assert no_labels.vertex_colors is None and ref.get_mesh("semseg").vertex_colors is None
    labels = np.random.default_rng(6).integers(-3, 45, tuple(ours.tsdf_vol.shape)).astype(np.int32)
    ours.attribute_vols["semseg"] = torch.from_numpy(labels)
    ref.attribute_vols["semseg"] = jnp.asarray(labels)
    ours_mesh, ref_mesh = ours.get_mesh("semseg"), ref.get_mesh("semseg")
    _assert_meshes_equal(ours_mesh, ref_mesh, 0.08)
    np.testing.assert_array_equal(ours_mesh.vertex_attributes["semseg"],
                                  ref_mesh.vertex_attributes["semseg"])
    assert len(np.unique(ours_mesh.vertex_colors, axis=0)) > 10


@pytest.mark.parametrize("colored", [False, True])
def test_ply_bytes_across_packages(tmp_path, colored):
    """The port's PLY equals the JAX Mesh.export byte for byte, and each
    package loads the other's file."""
    rng = np.random.default_rng(5)
    verts = rng.standard_normal((200, 3))
    faces = rng.integers(0, 200, (390, 3))
    colors = rng.integers(-30, 300, (200, 3)) if colored else None
    Mesh(verts, faces, colors).export(str(tmp_path / "port.ply"))
    JMesh(verts, faces, colors).export(str(tmp_path / "jax.ply"))
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    for reader, path in ((Mesh, "jax.ply"), (JMesh, "port.ply")):
        m = reader.load(str(tmp_path / path))
        np.testing.assert_array_equal(m.vertices, verts.astype(np.float32))
        np.testing.assert_array_equal(m.faces, faces)
        if colored:
            np.testing.assert_array_equal(m.vertex_colors, np.clip(colors, 0, 255).astype(np.uint8))
        else:
            assert m.vertex_colors is None
    empty = Mesh(np.zeros((0, 3)))
    empty.export(str(tmp_path / "empty.ply"))
    JMesh(np.zeros((0, 3))).export(str(tmp_path / "jax_empty.ply"))
    assert (tmp_path / "empty.ply").read_bytes() == (tmp_path / "jax_empty.ply").read_bytes()
    assert Mesh.load(str(tmp_path / "empty.ply")).is_empty


def test_host_library_build_rules(monkeypatch, tmp_path):
    """The library lands in the port's build directory keyed by source,
    flags, compiler and machine; a second build is the cached file; a
    missing compiler raises (there is no fallback)."""
    path = native.build_library()
    assert path.startswith(os.path.join(build_dir(), "host-"))
    assert native.build_library() == path and native.build_info["cached"]
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="not found"):
        native.build_library()


def test_importing_builds_nothing(tmp_path):
    """Importing the port's meshing and metric modules builds and loads no
    library: the build directory stays empty."""
    code = ("import gennerf_tpu_torch.utils.native as n, gennerf_tpu_torch.tsdf.tsdf, "
            "gennerf_tpu_torch.eval.evaluation, os\n"
            "print(n._lib is None, os.listdir(os.environ['GENNERF_TORCH_BUILD_DIR']))")
    env = dict(os.environ, GENNERF_TORCH_BUILD_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "[]"]


def test_host_library_rejects_malformed_input():
    """Shapes and face indices are checked before a pointer reaches C (the
    C code would read past the buffers)."""
    verts = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError, match="outside"):
        native.rasterize_depth(verts, [[0, 1, 4]], np.eye(3), np.eye(4), 4, 4)
    with pytest.raises(ValueError, match="pose"):
        native.rasterize_depth(verts, [[0, 1, 2]], np.eye(3), np.eye(3), 4, 4)
    with pytest.raises(ValueError, match=r"\(n, 3\)"):
        native.nn_distances(np.zeros((5, 2)), verts)
    with pytest.raises(ValueError, match="3 dimensions"):
        native.marching_cubes(np.zeros((4, 4)))
