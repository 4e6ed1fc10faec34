"""The port's render slice on the CPU against the JAX package: the surface
renderer (gennerf_tpu_torch.models.renderer vs gennerf_tpu/models/renderer.py)
on analytic fields, the own copies of `eval_depth` and the PNG writer, and
`render_views` against the sequence of scripts/local/render_views.py
(encode -> make_point_tsdf_fn(interpret=True) -> SurfaceRenderer -> z-depth
-> eval_depth), plus the render CLI.

Tolerances: the renderer on analytic fields agrees with JAX within 1e-5
(f32 in another order) and with the closed form within 2e-3 (the march's
own accuracy). eval_depth and the PNG bytes are exact. The whole slice
runs the point decode with bf16 feeds on both sides, summed in another
order: a ray whose field sample sits within a bf16 step of zero can find
its bracket one step over, so up to 2% of the rays may differ in their hit
mask, and rays hit on both sides agree within 1e-3 m at 98% of them
(measured at these widths: no ray differs, the largest depth difference
is 1.2e-7 m). With f32 marches (no kernel path) every ray agrees within
1e-4.
"""
import copy
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu.eval.metrics import eval_depth as j_eval_depth
from gennerf_tpu.models import renderer as jr
from gennerf_tpu.models.gen_nerf import GenNerf as JGenNerf
from gennerf_tpu.train import predict as jpred
from gennerf_tpu.utils.image import _write_png_raw
from gennerf_tpu_torch.data.synthetic import ring_frames
from gennerf_tpu_torch.eval.metrics import eval_depth
from gennerf_tpu_torch.models import renderer as tr
from gennerf_tpu_torch.models.config import GenNerfConfig, config_from_dict
from gennerf_tpu_torch.models.gen_nerf import GenNerf
from gennerf_tpu_torch.render import main as render_main
from gennerf_tpu_torch.render import render_views, view_indices
from gennerf_tpu_torch.train import predict as tpred
from gennerf_tpu_torch.utils.image import encode_png, write_png
from gennerf_tpu_torch.utils.port_params import gen_nerf_params_from_flax, save_params_npz
from test_torch_predict import CFG, PRIMS, REPO, VOXEL_DIM, _jax_draws, _t, scene, task_pair  # noqa: F401

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

D_GEO, SMOOTHING = 8, 1.05
K_SPHERE = np.array([[[40.0, 0, 16], [0, 40.0, 12], [0, 0, 1]]], np.float32)


@pytest.fixture(autouse=True)
def _f32_highest():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def views():
    """The two 12x16 frames of test_torch_predict's scene, with their cameras."""
    return ring_frames(2, 12, 16, (0.64, 0.64, 0.25), PRIMS, camera_radius=1.4,
                       camera_height=0.8, cameras=True)


def _sphere_pose():
    pose = np.eye(4, dtype=np.float32)[None]
    pose[0, 2, 3] = -2.0  # camera at z=-2 looking +z
    return pose


def _sphere_rays():
    origins = np.tile(np.array([[0.0, 0.0, -2.0]], np.float32), (1, 8, 1))
    angles = np.linspace(-0.15, 0.15, 8).astype(np.float32)
    dirs = np.stack([np.sin(angles), np.zeros(8, np.float32), np.cos(angles)], -1)[None]
    t_true = []
    for d in dirs[0]:
        b = origins[0, 0] @ d
        t_true.append(-b - np.sqrt(b**2 - (origins[0, 0] @ origins[0, 0] - 0.25)))
    return origins, dirs.astype(np.float32), np.array(t_true)


def _sdf_t(p):
    return torch.linalg.norm(p, dim=-1) - 0.5


def _sdf_j(p):
    return jnp.linalg.norm(p, axis=-1) - 0.5


def test_pixels_to_rays_matches_jax(rng):
    K = np.array([[[30.0, 0, 8.5], [0, 28.0, 6.0], [0, 0, 1]]] * 2, np.float32)
    a = rng.uniform(-0.5, 0.5, 2)
    pose = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    pose[:, 0, 0] = pose[:, 2, 2] = np.cos(a)
    pose[:, 0, 2], pose[:, 2, 0] = np.sin(a), -np.sin(a)
    pose[:, :3, 3] = rng.standard_normal((2, 3))
    h = rng.integers(0, 12, (2, 20)).astype(np.float32)
    w = rng.integers(0, 16, (2, 20)).astype(np.float32)
    o_j, d_j = jr.pixels_to_rays(jnp.asarray(h), jnp.asarray(w), jnp.asarray(K), jnp.asarray(pose))
    o_t, d_t = tr.pixels_to_rays(_t(h), _t(w), _t(K), _t(pose))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0, atol=1e-6)


def test_ray_aabb_clip(rng):
    origins = np.array([[[0.0, 0.0, -2.0], [0.0, 0.0, -2.0], [5.0, 0.0, -2.0]]], np.float32)
    dirs = np.array([[[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]], np.float32)
    box = (-np.ones(3, np.float32), np.ones(3, np.float32))
    t_near, t_far = tr.ray_aabb_clip(_t(origins), _t(dirs), _t(box[0]), _t(box[1]), 0.1, 10.0)
    np.testing.assert_allclose(t_near[0].numpy(), [1.0, 10.0, 10.0], atol=1e-6)
    np.testing.assert_allclose(t_far[0].numpy(), [3.0, 10.0, 10.0], atol=1e-6)
    o = rng.uniform(-3, 3, (2, 50, 3)).astype(np.float32)
    d = rng.standard_normal((2, 50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = jr.ray_aabb_clip(jnp.asarray(o), jnp.asarray(d), jnp.asarray(box[0]),
                           jnp.asarray(box[1]), 0.05, 5.0)
    ours = tr.ray_aabb_clip(_t(o), _t(d), _t(box[0]), _t(box[1]), 0.05, 5.0)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("convention", ["sdf", "fusion"])
@pytest.mark.parametrize("n_fine,aabb", [(0, False), (8, False), (8, True)])
def test_ray_march_sphere(convention, n_fine, aabb):
    """An analytic sphere in both conventions: the port's march equals
    JAX's and finds the closed-form depths."""
    origins, dirs, t_true = _sphere_rays()
    sign = 1.0 if convention == "sdf" else -1.0
    box = (np.full(3, -0.6, np.float32), np.full(3, 0.6, np.float32))
    kw = dict(near=0.1, far=4.0, n_steps=64 if n_fine == 0 else 16, n_secant_steps=8,
              n_fine_steps=n_fine, convention=convention)
    d_t, m_t = tr.ray_march_tsdf(lambda p: sign * _sdf_t(p), _t(origins), _t(dirs),
                                 aabb=tuple(map(_t, box)) if aabb else None, **kw)
    d_j, m_j = jr.ray_march_tsdf(lambda p: sign * _sdf_j(p), jnp.asarray(origins),
                                 jnp.asarray(dirs),
                                 aabb=tuple(map(jnp.asarray, box)) if aabb else None, **kw)
    assert m_t.all() and np.asarray(m_j).all()
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(d_t[0].numpy(), t_true, rtol=0, atol=2e-3)


def test_ray_march_misses_and_first_crossing():
    # a ray far from the sphere finds nothing
    depth, mask = tr.ray_march_tsdf(lambda p: torch.linalg.norm(p, dim=-1) - 0.2,
                                    _t(np.array([[[0.0, 2.0, -2.0]]], np.float32)),
                                    _t(np.array([[[0.0, 0.0, 1.0]]], np.float32)),
                                    convention="sdf")
    assert not mask[0, 0] and depth[0, 0] == 0.0
    # two crossings on a row: the first is taken
    vals = _t(np.array([[[1.0, -1.0, 1.0, -1.0]]], np.float32))
    ts = _t(np.array([0.0, 1.0, 2.0, 3.0], np.float32))
    t_lo, t_hi, _, _, any_cross = tr._first_crossing(vals, ts)
    assert any_cross.item() and (t_lo.item(), t_hi.item()) == (0.0, 1.0)
    with pytest.raises(ValueError, match="convention"):
        tr.ray_march_tsdf(_sdf_t, _t(np.zeros((1, 1, 3), np.float32)),
                          _t(np.ones((1, 1, 3), np.float32)), convention="occupancy")


def _sphere_decode_t(pts):
    return {"tsdf": _sdf_t(pts)[..., None], "feat_sem": pts[..., :2]}


def _sphere_decode_j(pts):
    return {"tsdf": _sdf_j(pts)[..., None], "feat_sem": pts[..., :2]}


def test_render_depth_image_chunking_and_jax():
    """100-ray chunks (ragged tail) equal one chunk, and both equal JAX."""
    H, W = 24, 32
    kw = dict(near=0.1, far=5.0, n_steps=16, convention="sdf")
    big = tr.SurfaceRenderer(_sphere_decode_t, n_max_network_queries=1 << 20, **kw)
    small = tr.SurfaceRenderer(_sphere_decode_t, n_max_network_queries=16 * 100, **kw)
    d_big = big.render_depth_image(_t(K_SPHERE), _t(_sphere_pose()), H, W)
    d_small = small.render_depth_image(_t(K_SPHERE), _t(_sphere_pose()), H, W)
    assert d_big.shape == (1, H, W) and (d_big > 0).any() and (d_big == 0).any()
    np.testing.assert_array_equal(d_small.numpy(), d_big.numpy())
    ref = jr.SurfaceRenderer(_sphere_decode_j, **kw).render_depth_image(
        jnp.asarray(K_SPHERE), jnp.asarray(_sphere_pose()), H, W)
    np.testing.assert_allclose(d_big.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_render_feature_image():
    """Chunked == single-shot; features are the decode at the surface point
    on hit rays and 0 on missed ones; JAX renders the same."""
    H, W = 24, 32
    kw = dict(near=0.1, far=5.0, n_steps=16, convention="sdf")
    K, pose = _t(K_SPHERE), _t(_sphere_pose())
    big = tr.SurfaceRenderer(_sphere_decode_t, n_max_network_queries=1 << 20, **kw)
    small = tr.SurfaceRenderer(_sphere_decode_t, n_max_network_queries=16 * 100, **kw)
    db, mb, fb = big.render_feature_image(K, pose, H, W)
    ds, ms, fs = small.render_feature_image(K, pose, H, W)
    assert fb.shape == (1, H, W, 2) and mb.shape == (1, H, W)
    np.testing.assert_array_equal(fs.numpy(), fb.numpy())
    np.testing.assert_array_equal(ms.numpy(), mb.numpy())
    mb_np, fb_np = mb[0].numpy(), fb[0].numpy()
    assert mb_np.any() and (~mb_np).any() and np.all(fb_np[~mb_np] == 0.0)
    hs, ws = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32), indexing="ij")
    o, d = tr.pixels_to_rays(hs.reshape(1, -1), ws.reshape(1, -1), K, pose)
    pts = (o + d * db.reshape(1, -1, 1))[0].reshape(H, W, 3).numpy()
    np.testing.assert_allclose(fb_np[mb_np], pts[mb_np][:, :2], atol=1e-6)
    rd, rm, rf = jr.SurfaceRenderer(_sphere_decode_j, **kw).render_feature_image(
        jnp.asarray(K_SPHERE), jnp.asarray(_sphere_pose()), H, W)
    np.testing.assert_array_equal(mb.numpy(), np.asarray(rm))
    np.testing.assert_allclose(fb.numpy(), np.asarray(rf), rtol=0, atol=1e-5)


def test_eval_depth_matches_jax(rng):
    pred = rng.uniform(0.2, 4.0, (12, 16)).astype(np.float32)
    trgt = rng.uniform(0.2, 4.0, (12, 16)).astype(np.float32)
    pred[rng.random((12, 16)) < 0.3] = 0
    trgt[rng.random((12, 16)) < 0.2] = 0
    assert eval_depth(pred, trgt) == j_eval_depth(pred, trgt)
    zeros = np.zeros_like(pred)
    assert eval_depth(zeros, trgt) == j_eval_depth(zeros, trgt)


@pytest.mark.parametrize("shape,dtype", [((7, 5), np.uint8), ((7, 5, 3), np.uint8),
                                         ((7, 5, 4), np.uint8), ((7, 5), np.uint16)])
def test_encode_png_matches_jax(rng, tmp_path, shape, dtype):
    """Byte-equal to the JAX package's own writer (its PIL-free path)."""
    arr = rng.integers(0, np.iinfo(dtype).max, shape).astype(dtype)
    _write_png_raw(str(tmp_path / "ref.png"), arr)
    ref = (tmp_path / "ref.png").read_bytes()
    assert encode_png(arr) == ref
    write_png(str(tmp_path / "ours.png"), arr)
    assert (tmp_path / "ours.png").read_bytes() == ref


def test_ring_frames_cameras(scene, views):
    P, image, depth, K, pose = views
    assert K.shape == (2, 3, 3) and pose.shape == (2, 4, 4)
    for t in range(2):
        np.testing.assert_allclose(P[t], (K[t] @ np.linalg.inv(pose[t])[:3]).astype(np.float32))
    base = ring_frames(2, 12, 16, (0.64, 0.64, 0.25), PRIMS, camera_radius=1.4, camera_height=0.8)
    assert len(base) == 3
    for a, b, c in zip(base, views[:3], scene):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert list(view_indices(8, 4)) == [0, 2, 4, 7] and list(view_indices(2, 4)) == [0, 1]


@pytest.fixture(scope="module")
def field_pair(task_pair, views):
    """The JAX task and the port model with lin_out's bias moved along the
    head so that the median of the decoded grid is 0: the random field
    then crosses zero inside the volume."""
    task, state, _, tree, model = task_pair
    P, image, depth = views[:3]
    sel, start = _jax_draws(2, 12 * 16, 64)
    repr_ = model.encode(_t(P)[None], _t(image)[None], _t(depth)[None], sel=sel, start=start)
    vol = tpred.predict_tsdf_volume(model, repr_, VOXEL_DIM, 0.08, torch.zeros(3))
    shift = -np.arctanh(np.median(vol.numpy()) / SMOOTHING)
    tree = copy.deepcopy(tree)
    w_head = tree["head_geo"]["Dense_0"]["kernel"][:, 0].astype(np.float64)
    bias = tree["mlp"]["lin_out"]["bias"]
    bias[:D_GEO] = (bias[:D_GEO] + shift * w_head / (w_head @ w_head)).astype(np.float32)
    state = types.SimpleNamespace(params=jax.tree.map(jnp.asarray, tree), batch_stats={})
    shifted = GenNerf(model.cfg)
    shifted.load_state_dict(gen_nerf_params_from_flax(tree))
    return task, state, tree, shifted.eval()


def _jax_render_sequence(task, state, views, use_fused):
    """scripts/local/render_views.py's per-scene body, on the CPU."""
    P, image, depth, K, pose = views
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    cfg = task.cfg
    repr_, _ = task.model.apply(
        variables, jnp.asarray(P[None]), jnp.asarray(image[None]), jnp.asarray(depth[None]),
        jax.random.PRNGKey(0), tuple(cfg.voxel_dim_test), jnp.zeros(3), train=False,
        method=JGenNerf.encode, mutable=["batch_stats"])

    def decode_fn(pts):
        return task.model.apply(variables, repr_, pts, jnp.zeros(3), method=JGenNerf.decode)

    tsdf_fn = (jpred.make_point_tsdf_fn(task.model, variables, repr_, np.zeros(3), tile=128,
                                        interpret=True) if use_fused else None)
    vol_size = np.array(cfg.voxel_dim_test, np.float32) * cfg.voxel_size
    renderer = jr.SurfaceRenderer(decode_fn, near=0.05, far=5.0, tsdf_fn=tsdf_fn,
                                  aabb=(np.zeros(3, np.float32), vol_size))
    T, H, W = depth.shape
    zs, metrics = [], []
    hs, ws = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    for vi in np.linspace(0, T - 1, min(4, T)).astype(int):
        Kv, posev = jnp.asarray(K[vi][None]), jnp.asarray(pose[vi][None])
        t_ray = np.asarray(renderer.render_depth_image(Kv, posev, H, W))[0]
        _, dirs = jr.pixels_to_rays(jnp.asarray(hs.reshape(1, -1), jnp.float32),
                                    jnp.asarray(ws.reshape(1, -1), jnp.float32), Kv, posev)
        z = t_ray * (np.asarray(dirs)[0] @ pose[vi][:3, 2]).reshape(H, W)
        zs.append(z)
        metrics.append(j_eval_depth(z, depth[vi]))
    return np.stack(zs), metrics


@pytest.mark.parametrize("kernel_path", [True, False])
def test_render_views_matches_jax_sequence(field_pair, views, kernel_path):
    task, state, _, model = field_pair
    ref_z, ref_metrics = _jax_render_sequence(task, state, views, kernel_path)
    sel, start = _jax_draws(2, 12 * 16, 64)
    out = render_views(model, *views, use_kernel_path=kernel_path, sel=sel, start=start)
    assert list(out["views"]) == [0, 1] and out["depth"].shape == ref_z.shape
    hit, ref_hit = out["depth"] > 0, ref_z > 0
    assert ref_hit.mean() > 0.2, "the shifted field must cross zero in view"
    both = hit & ref_hit
    close = np.abs(out["depth"] - ref_z)[both]
    if kernel_path:
        assert (hit != ref_hit).mean() <= 0.02
        assert (close < 1e-3).mean() >= 0.98
    else:
        np.testing.assert_array_equal(hit, ref_hit)
        assert close.max() < 1e-4
        for ours, ref in zip(out["metrics"], ref_metrics):
            for k in ref:
                assert abs(ours[k] - ref[k]) < 1e-4, k
    assert set(out["mean"]) == set(ref_metrics[0])


def test_render_views_features(field_pair, views):
    model = field_pair[-1]
    sel, start = _jax_draws(2, 12 * 16, 64)
    out = render_views(model, *views, num_views=1, features=True, sel=sel, start=start)
    rgb = out["feature_rgb"]
    assert rgb.shape == (1, 12, 16, 3) and rgb.dtype == np.uint8
    # black exactly where the march found no surface
    np.testing.assert_array_equal(rgb[0].any(-1) | (out["ray_depth"][0] > 0),
                                  out["ray_depth"][0] > 0)
    assert rgb.any()


def test_render_cli_on_cpu(field_pair, views, tmp_path):
    """`python -m gennerf_tpu_torch.render` end to end on a small
    experiment: PNGs, render_metrics.json and the printed mean."""
    _, _, tree, model = field_pair
    import shutil

    shutil.copytree(os.path.join(REPO, "configs"), tmp_path / "configs")
    (tmp_path / "configs" / "experiment" / "tiny_port.yaml").write_text(
        "defaults:\n  - overfit_synthetic\n"
        "model:\n  encoder:\n    pointnet:\n      num_sparse_points: 32\n      fps_presample: 64\n"
        "      c_dim: 8\n      hidden_dim: 8\n      plane_resolution: 16\n      n_blocks: 2\n"
        "      unet_kwargs: {depth: 2, merge_mode: concat, start_filts: 8}\n"
        "  mlp: {d_out_geo: 8, d_out_sem: 1, n_blocks: 2, d_hidden: 32, alpha: 0.7, head_smoothing: 1.05}\n"
        "data:\n  voxel_size: 0.08\n  voxel_dim_train: [16, 16, 8]\n  voxel_dim_test: [16, 16, 8]\n")
    save_params_npz(str(tmp_path / "params.npz"), tree)
    P, image, depth, K, pose = views
    np.savez(tmp_path / "frames.npz", projection=P, image=image, depth=depth, intrinsics=K,
             pose=pose)
    args = ["--config", str(tmp_path / "configs" / "experiment" / "tiny_port.yaml"),
            "--params", str(tmp_path / "params.npz"), "--frames", str(tmp_path / "frames.npz"),
            "--out", str(tmp_path / "out"), "--features"]
    mean = render_main(args + ["--device", "cpu"])
    expect = render_views(model, *views, generator=torch.Generator().manual_seed(0))
    assert mean == expect["mean"]
    with open(tmp_path / "out" / "render_metrics.json") as f:
        assert json.load(f)["mean"] == mean
    for vi in (0, 1):
        for suffix in ("", "_feat"):
            assert (tmp_path / "out" / f"view{vi:03d}{suffix}.png").read_bytes()[:4] == b"\x89PNG"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            render_main(args)
