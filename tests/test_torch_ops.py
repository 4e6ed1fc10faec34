"""Parity of the port's ops (gennerf_tpu_torch.ops, positional encoding,
FPS) with the JAX package on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its port. Float results agree within 1e-5 absolute (float32 arithmetic in
a different order); integer results (indices, FPS picks) are identical.
The JAX draws (FPS start, presample) are computed from their keys and
injected into the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu.models.positional_encoding import positional_encoding as j_pe
from gennerf_tpu.ops import coords as jc
from gennerf_tpu.ops import interpolation as ji
from gennerf_tpu.ops import projection as jp
from gennerf_tpu.ops import scatter as js
from gennerf_tpu.ops.pallas.fps import fps_pallas
from gennerf_tpu.ops.sampling import farthest_point_sample as j_fps
from gennerf_tpu_torch.data.synthetic import look_at_pose
from gennerf_tpu_torch.models.positional_encoding import positional_encoding as t_pe
from gennerf_tpu_torch.ops import coords as tc
from gennerf_tpu_torch.ops import interpolation as ti
from gennerf_tpu_torch.ops import projection as tp
from gennerf_tpu_torch.ops import sampling as tsamp
from gennerf_tpu_torch.ops import scatter as ts

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def _projections(T, H, W, seed=0):
    """Ring cameras looking at a point: realistic, well-conditioned P = K inv(pose)."""
    rng = np.random.default_rng(seed)
    f = 0.6 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    out = []
    for i in range(T):
        ang = 2 * np.pi * i / T + 0.1 * rng.standard_normal()
        eye = np.array([1.6 + 2.2 * np.cos(ang), 1.6 + 2.2 * np.sin(ang), 1.3])
        pose = look_at_pose(eye, (1.6, 1.6, 0.4))
        out.append((K @ np.linalg.inv(pose)[:3]).astype(np.float32))
    return np.stack(out)


@pytest.fixture(autouse=True)
def _f32_highest():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


# -- coords ------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 7, 40, 56, 80, 96])
def test_linspace_matches_jnp(n):
    ours = tc.linspace(0.0, 0.04 * n, n)
    ref = jnp.linspace(0.0, 0.04 * n, n, dtype=jnp.float32)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_grid_coordinates():
    ours = tc.grid_coordinates(5, 4, 3, [0.2, 0.16, 0.12])
    ref = jc.grid_coordinates(5, 4, 3, [0.2, 0.16, 0.12])
    _close(ours, ref)


@pytest.mark.parametrize("plane", ["xz", "xy", "yz"])
def test_normalize_coordinate(rng, plane):
    p = rng.uniform(-0.7, 0.7, (2, 50, 3)).astype(np.float32)
    _close(tc.normalize_coordinate(_t(p), 0.1, plane), jc.normalize_coordinate(jnp.asarray(p), 0.1, plane))


@pytest.mark.parametrize("coord_type,dim", [("2d", 2), ("3d", 3)])
def test_coordinate2index(rng, coord_type, dim):
    x = rng.uniform(0, 1 - 1e-5, (2, 64, dim)).astype(np.float32)
    ours = tc.coordinate2index(_t(x), 16, coord_type)
    ref = jc.coordinate2index(jnp.asarray(x), 16, coord_type)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


# -- projection --------------------------------------------------------------

def test_homogenize_projection():
    P = _projections(3, 12, 16)
    np.testing.assert_array_equal(tp.homogenize_projection(_t(P)).numpy(),
                                  np.asarray(jp.homogenize_projection(jnp.asarray(P))))


def test_get_3d_points(rng):
    P = _projections(2, 12, 16)
    depth = rng.uniform(0.5, 3.0, (2, 12, 16)).astype(np.float32)
    depth[:, 0, :3] = 0.0
    _close(tp.get_3d_points(_t(depth), _t(P)), jp.get_3d_points(jnp.asarray(depth), jnp.asarray(P)))


def test_project_voxels():
    P = _projections(2, 12, 16)
    origin = np.array([-0.4, -0.2, 0.0], np.float32)
    ours = tp.project_voxels((8, 8, 6), 0.45, _t(origin), _t(P), 12, 16)
    ref = jp.project_voxels((8, 8, 6), 0.45, jnp.asarray(origin), jnp.asarray(P), 12, 16)
    for name, o, r in zip(("px", "py", "pz", "valid"), ours, ref):
        if name == "pz":
            _close(o, r)
        else:
            np.testing.assert_array_equal(o.numpy(), np.asarray(r), err_msg=name)
    assert np.asarray(ref[3]).any() and not np.asarray(ref[3]).all()


# -- scatter -----------------------------------------------------------------

@pytest.fixture
def seg_inputs(rng):
    values = rng.standard_normal((2, 100, 5)).astype(np.float32)
    index = rng.integers(0, 12, (2, 100)).astype(np.int32)  # segments 12..15 stay empty
    return values, index


@pytest.mark.parametrize("name", ["segment_sum", "segment_mean", "segment_max"])
def test_segment_reductions(seg_inputs, name):
    values, index = seg_inputs
    ours = getattr(ts, name)(_t(values), _t(index).long(), 16)
    ref = getattr(js, name)(jnp.asarray(values), jnp.asarray(index), 16)
    _close(ours, ref)
    assert np.all(ours.numpy()[:, 12:] == 0.0)


def test_segment_sum_keeps_dtype_accumulates_f32(seg_inputs):
    values, index = seg_inputs
    v16 = _t(values).to(torch.bfloat16)
    out = ts.segment_sum(v16, _t(index).long(), 16)
    assert out.dtype == torch.bfloat16
    ref = js.segment_sum(jnp.asarray(values).astype(jnp.bfloat16), jnp.asarray(index), 16)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("reduce", ["mean", "max", "sum"])
def test_scatter_to_plane(seg_inputs, reduce):
    values, index = seg_inputs
    _close(ts.scatter_to_plane(_t(values), _t(index).long(), 4, reduce),
           js.scatter_to_plane(jnp.asarray(values), jnp.asarray(index), 4, reduce))


@pytest.mark.parametrize("reduce", ["max", "mean"])
def test_pool_and_gather(seg_inputs, reduce):
    values, index = seg_inputs
    _close(ts.pool_and_gather(_t(values), _t(index).long(), 16, reduce),
           js.pool_and_gather(jnp.asarray(values), jnp.asarray(index), 16, reduce))


# -- interpolation -----------------------------------------------------------

@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_2d(rng, mode):
    image = rng.standard_normal((2, 3, 7, 9)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 5, 4, 2)).astype(np.float32)  # some outside: border
    _close(ti.grid_sample_2d(_t(image), _t(grid), mode),
           ji.grid_sample_2d(jnp.asarray(image), jnp.asarray(grid), mode))


def test_sample_plane_feature(rng):
    planes = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    p = rng.uniform(0, 1 - 1e-5, (2, 30, 2)).astype(np.float32)
    _close(ti.sample_plane_feature(_t(planes), _t(p)),
           ji.sample_plane_feature(jnp.asarray(planes), jnp.asarray(p)))


# -- positional encoding -----------------------------------------------------

@pytest.mark.parametrize("num_freqs,include_input", [(6, True), (2, False)])
def test_positional_encoding(rng, num_freqs, include_input):
    x = rng.uniform(-2, 4, (3, 10, 3)).astype(np.float32)
    _close(t_pe(_t(x), num_freqs, 0.5, include_input),
           j_pe(jnp.asarray(x), num_freqs, 0.5, include_input))


# -- sampling ----------------------------------------------------------------

def test_uniform_presample_injected_draw(rng):
    """The presample with the JAX draw (split(key)[1]) injected gives the
    JAX encoder's presampled cloud."""
    xyz = rng.standard_normal((4, 200, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    _, k_pre = jax.random.split(key)
    sel = jax.random.randint(k_pre, (4, 64), 0, 200)
    ref = jnp.take_along_axis(jnp.asarray(xyz), sel[..., None], axis=1)
    ours = tsamp.uniform_presample(_t(xyz), 64, sel=_t(sel))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert tsamp.uniform_presample(_t(xyz), 256) is not None  # N <= presample: identity
    np.testing.assert_array_equal(tsamp.uniform_presample(_t(xyz), 256).numpy(), xyz)


def _fps_cases(rng):
    cases = [
        ("random_8x256", rng.standard_normal((8, 256, 3)).astype(np.float32), 32),
        ("random_8x384_odd", rng.standard_normal((8, 384, 3)).astype(np.float32), 17),
    ]
    base = rng.standard_normal((8, 64, 3)).astype(np.float32)
    cases.append(("duplicated_halves", np.concatenate([base, base], axis=1), 16))
    # a depth cloud presampled with replacement: many exact duplicates, and
    # invalid pixels all unprojecting to the camera center
    P = _projections(8, 12, 16)
    depth = rng.uniform(0.5, 3.0, (8, 12, 16)).astype(np.float32)
    depth[:, :2] = 0.0
    cloud = np.asarray(jp.get_3d_points(jnp.asarray(depth), jnp.asarray(P))).reshape(8, -1, 3)
    sel = rng.integers(0, cloud.shape[1], (8, 256))
    cases.append(("presampled_depth", np.take_along_axis(cloud, sel[..., None], 1), 48))
    # past the 32768 points the port's kernel once capped: a cloud the JAX
    # function takes through its XLA loop
    cases.append(("past_old_cap_2x40000", rng.standard_normal((2, 40000, 3)).astype(np.float32), 12))
    return cases


@pytest.mark.parametrize("case", range(5))
def test_fps_plain_identical_to_jax(rng, case):
    """Plain FPS = the JAX fori_loop = the Pallas kernel (interpret mode),
    index for index, duplicates and ties included."""
    name, xyz, npoint = _fps_cases(rng)[case]
    B, N, _ = xyz.shape
    key = jax.random.PRNGKey(5 + case)
    start = np.asarray(jax.random.randint(key, (B,), 0, N))
    _, c_xla = j_fps(key, jnp.asarray(xyz), npoint, use_pallas=False)
    _, c_pallas = fps_pallas(key, jnp.asarray(xyz), npoint, interpret=True)
    ours = tsamp.farthest_point_sample_plain(_t(xyz), npoint, _t(start))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(c_xla), err_msg=name)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(c_pallas), err_msg=name)


def test_fps_wrapper_cpu_goes_plain(rng):
    xyz = rng.standard_normal((3, 100, 3)).astype(np.float32)
    start = torch.tensor([0, 5, 99])
    sampled, idx = tsamp.farthest_point_sample(_t(xyz), 10, start=start)
    np.testing.assert_array_equal(idx.numpy(), tsamp.farthest_point_sample_plain(_t(xyz), 10, start).numpy())
    np.testing.assert_array_equal(sampled.numpy(), np.take_along_axis(xyz, idx.numpy()[..., None].astype(np.int64), 1))
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    np.testing.assert_array_equal(tsamp.farthest_point_sample(_t(xyz), 10, g1)[1].numpy(),
                                  tsamp.farthest_point_sample(_t(xyz), 10, g2)[1].numpy())

