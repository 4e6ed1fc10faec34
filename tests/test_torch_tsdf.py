"""The port's TSDF volume layer on the CPU against the JAX package:
the transform's sampler, `TSDF.transform` (the ground-truth resample of
3D augmentation), the npz layout across both packages (and the mesh of a
JAX-written volume) and `eval_tsdf`.

Tolerances:
- the sampler against grid_sample_3d: 1e-6 absolute (float32 lerps in the
  same order);
- TSDF.transform: the two packages round a voxel's float32 sample
  coordinates differently (XLA fuses and reorders the arithmetic), so a
  coordinate that lies on a rounding tie of the nearest tap can round
  the other way and take the other voxel's plateau value. Such
  voxels are counted: at most 0.1% of the volume may differ by more than
  1e-5, and every other voxel agrees within 1e-5;
- eval_tsdf: 1e-6 (numpy on both sides).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu.eval.metrics import eval_tsdf as j_eval_tsdf
from gennerf_tpu.ops.interpolation import grid_sample_3d as j_grid_sample_3d
from gennerf_tpu.tsdf.tsdf import TSDF as JTSDF
from gennerf_tpu_torch.data.synthetic import ring_frames
from gennerf_tpu_torch.eval.metrics import eval_tsdf
from gennerf_tpu_torch.tsdf.fusion import fuse_frames
from gennerf_tpu_torch.tsdf.tsdf import TSDF, _resample

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

VOXEL_SIZE = 0.08
TRANSFORM_TOL, TIE_SHARE = 1e-5, 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def fused():
    """A fused ground-truth volume (40 x 40 x 20 at 8 cm, origin (-1.6,
    -1.6, -0.16)) of a sphere and a box: +1 plateau, -1 plateau and the
    band between, plus a float 'color' and an integer 'instance' volume."""
    prims = [{"type": "sphere", "center": (0.3, -0.2, 0.35), "radius": 0.35},
             {"type": "box", "min": (-0.7, 0.1, 0.0), "max": (-0.2, 0.6, 0.5)}]
    P, _, depth = ring_frames(6, 24, 32, (0.0, 0.0, 0.4), prims)
    origin = np.array([-1.6, -1.6, -0.16], np.float32)
    state = fuse_frames((40, 40, 20), VOXEL_SIZE, _t(origin), 3 * VOXEL_SIZE, _t(P), _t(depth))
    vol = state.tsdf.reshape(40, 40, 20).numpy()
    rng = np.random.default_rng(0)
    attrs = {"color": rng.uniform(0, 255, (3, 40, 40, 20)).astype(np.float32),
             "instance": rng.integers(0, 5, (40, 40, 20)).astype(np.int32)}
    assert (vol == 1).any() and (vol == -1).any() and (np.abs(vol) < 1).any()
    return origin.reshape(1, 3), vol, attrs


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_grid_sample_3d_matches_jax(mode):
    """The transform's sampler against the JAX grid_sample_3d as the JAX
    TSDF.transform calls it: zeros padding, align_corners False, taps
    inside, across and outside the border."""
    rng = np.random.default_rng(1)
    vol = rng.standard_normal((3, 5, 6, 7)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (200, 3)).astype(np.float32)
    ref = j_grid_sample_3d(jnp.asarray(vol[None]), jnp.asarray(grid[None, :, ::-1].copy()),
                           mode=mode, align_corners=False, padding_mode="zeros")[0]
    dims = np.array(vol.shape[1:], np.float32).reshape(3, 1)
    ours = _resample(vol, ((grid.T + 1.0) * dims - 1.0) * 0.5, mode)
    assert ours.shape == (3, 200) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=1e-6)


def _rigid(angle: float, translation) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(angle), np.sin(angle)
    m[:2, :2] = [[c, -s], [s, c]]
    m[:3, 3] = translation
    return m


@pytest.mark.parametrize("case", ["rotation", "translation"])
def test_tsdf_transform_matches_jax(fused, case):
    origin, vol, attrs = fused
    # a generic offset: a y shift of -0.41 would put a whole plane of voxels
    # on a rounding tie of the nearest tap and flip its plateau voxels
    # wherever the last bit differs
    matrix = (_rigid(0.7, (0.0, 0.0, 0.0)) if case == "rotation"
              else _rigid(0.0, (0.2337, -0.4113, 0.0519)))
    new_origin = np.array([-1.2, -1.0, -0.3], np.float32)
    voxel_dim = (30, 36, 18)
    ref = JTSDF(VOXEL_SIZE, jnp.asarray(origin), jnp.asarray(vol),
                {k: jnp.asarray(v) for k, v in attrs.items()}).transform(
        jnp.asarray(matrix), voxel_dim, jnp.asarray(new_origin))
    ours = TSDF(VOXEL_SIZE, _t(origin), _t(vol), {k: _t(v) for k, v in attrs.items()}).transform(
        _t(matrix), voxel_dim, new_origin)
    got, want = ours.tsdf_vol.numpy(), np.asarray(ref.tsdf_vol)
    assert got.shape == voxel_dim and got.dtype == np.float32
    np.testing.assert_array_equal(ours.origin.numpy(), np.asarray(ref.origin))
    ties = np.abs(got - want) > TRANSFORM_TOL
    print(f"{case}: {int(ties.sum())} of {got.size} voxels took the other nearest tap")
    assert ties.mean() <= TIE_SHARE, (int(ties.sum()), got.size)
    # the volume holds every kind of voxel: out of bounds (1), both plateaus, the band
    assert (want == 1).any() and (want == -1).any() and ((np.abs(want) < 1) & (want != 0)).any()
    for key in attrs:
        a, b = ours.attribute_vols[key].numpy(), np.asarray(ref.attribute_vols[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        bad = np.abs(a.astype(np.float64) - b) > (TRANSFORM_TOL * 255 if key == "color" else 0)
        assert bad.mean() <= TIE_SHARE, (key, int(bad.sum()))


def test_transform_to_origin_zero_is_the_training_frame(fused):
    """RandomTransformSpace passes origin (0, 0, 0): the resampled volume's
    voxel 0 sits at the world origin, which the train step assumes."""
    origin, vol, _ = fused
    out = TSDF(VOXEL_SIZE, _t(origin), _t(vol)).transform(_t(_rigid(0.3, (0.1, 0.2, 0.0))),
                                                          (20, 20, 10), [0, 0, 0])
    assert out.origin.tolist() == [[0.0, 0.0, 0.0]] and out.tsdf_vol.shape == (20, 20, 10)


def test_tsdf_save_load_across_packages(fused, tmp_path):
    origin, vol, attrs = fused
    TSDF(VOXEL_SIZE, _t(origin), _t(vol), {k: _t(v) for k, v in attrs.items()}).save(
        str(tmp_path / "port.npz"))
    JTSDF(VOXEL_SIZE, jnp.asarray(origin), jnp.asarray(vol),
          {k: jnp.asarray(v) for k, v in attrs.items()}).save(str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for writer, reader in (("port", JTSDF), ("jax", TSDF)):
        t = reader.load(str(tmp_path / f"{writer}.npz"))
        assert t.voxel_size == VOXEL_SIZE and tuple(np.asarray(t.origin).shape) == (1, 3)
        np.testing.assert_array_equal(np.asarray(t.tsdf_vol), vol)
        np.testing.assert_array_equal(np.asarray(t.attribute_vols["instance"]), attrs["instance"])
    only = TSDF.load(str(tmp_path / "jax.npz"), ["tsdf"])
    assert only.attribute_vols == {}
    # the volume alone meshes as the JAX package meshes it
    mesh, ref = only.get_mesh(), JTSDF.load(str(tmp_path / "jax.npz"), ["tsdf"]).get_mesh()
    assert len(mesh.faces) > 0 and mesh.vertex_colors is None and ref.vertex_colors is None
    np.testing.assert_array_equal(mesh.faces, ref.faces)
    np.testing.assert_allclose(mesh.vertices, ref.vertices, rtol=0, atol=1e-5 * VOXEL_SIZE)


def test_eval_tsdf_matches_jax(fused):
    """Same grid (voxel to voxel), a shifted smaller grid (resampled in
    world space) and align=True."""
    origin, vol, _ = fused
    rng = np.random.default_rng(2)
    pred_same = np.clip(vol + 0.1 * rng.standard_normal(vol.shape), -1, 1).astype(np.float32)
    pred_other = rng.uniform(-1, 1, (44, 44, 24)).astype(np.float32)
    other_origin = origin - 0.24
    cases = [((pred_same, origin), {}), ((pred_other, other_origin), {}),
             ((pred_same, origin), {"align": True})]
    for (pred, p_origin), kw in cases:
        ours = eval_tsdf(TSDF(VOXEL_SIZE, _t(p_origin), _t(pred)), TSDF(VOXEL_SIZE, _t(origin), _t(vol)),
                         **kw)
        ref = j_eval_tsdf(JTSDF(VOXEL_SIZE, jnp.asarray(p_origin), jnp.asarray(pred)),
                          JTSDF(VOXEL_SIZE, jnp.asarray(origin), jnp.asarray(vol)), **kw)
        assert ours.keys() == ref.keys()
        assert ours["l1"] == pytest.approx(ref["l1"], abs=1e-6), kw
    assert eval_tsdf(pred_same, vol) == pytest.approx(j_eval_tsdf(pred_same, vol), abs=1e-6)
