"""Parity of the port's arbitrary-point decode with the JAX package on the
CPU: the point-decode weights and their plain version
(gennerf_tpu_torch.ops.point_decode) against ops/pallas/fused_decoder.py's
point kernel run in interpret mode, and train/predict.py's triplane gather,
`make_point_tsdf_fn`, `decode_dense_fused` and the sparse band decode
against gennerf_tpu/train/predict.py.

Sizes are small (c_dim 8, H 32, 2 blocks, d_code 39, a 16x16x8 grid). The
JAX weights come through gen_nerf_params_from_flax (the fixtures of
test_torch_predict.py). Tolerances:
- packing: the bf16 matrices are the same roundings of the same values;
- the plain bf16-feed decode vs the Pallas point kernel in interpret mode:
  both round every product input to bf16 and accumulate in f32, but in
  another order, so an activation within an ulp of a bf16 rounding
  boundary can round the other way (one bf16 step is 2^-8 of the value):
  fewer than 1% of points differ by more than 1e-4, the mean difference
  is under 1e-5 and the largest under 5e-2 (the f32 decode is more than
  10x further away on average; at these widths no point flipped and the
  largest difference was 2.6e-7);
- the triplane gather: rtol 1e-5 (bf16 texels weighted and summed in f32
  in another order);
- the sparse band decode: 1e-5 (f32 on both sides).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu.models.gen_nerf import GenNerf as JGenNerf
from gennerf_tpu.models.gen_nerf import SceneRepr as JRepr
from gennerf_tpu.models.positional_encoding import positional_encoding as j_pe
from gennerf_tpu.ops.pallas import fused_decoder as jfd
from gennerf_tpu.train import predict as jpred
from gennerf_tpu.train.tasks import GenNerfTask
from gennerf_tpu_torch.models.config import GenNerfConfig, config_from_dict
from gennerf_tpu_torch.models.gen_nerf import GenNerf, SceneRepr
from gennerf_tpu_torch.ops import grid_decode as gd
from gennerf_tpu_torch.ops import point_decode as pd
from gennerf_tpu_torch.ops.weight_slabs import unpack_decode_weights
from gennerf_tpu_torch.predict import reconstruct
from gennerf_tpu_torch.train import predict as tpred
from gennerf_tpu_torch.tsdf.fusion import apply_fusion_prior
from gennerf_tpu_torch.utils.port_params import gen_nerf_params_from_flax
from test_torch_predict import CFG, VOXEL_DIM, _jax_draws, _t, scene, task_pair  # noqa: F401

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

NB, D_GEO, SMOOTHING = 2, 8, 1.05


@pytest.fixture(autouse=True)
def _f32_highest():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def weights(task_pair):
    """The JAX packed weights and the port's, from the same params."""
    _, state, _, _, model = task_pair
    jw = jfd.extract_resnetfc_weights(state.params["mlp"], state.params["head_geo"], NB, D_GEO,
                                      head_smoothing=SMOOTHING)
    tw = pd.pack_point_weights(gd.extract_resnetfc_weights(model.mlp, model.head_geo, D_GEO,
                                                           SMOOTHING))
    return jw, tw


@pytest.fixture(scope="module")
def planes():
    rng = np.random.default_rng(7)
    return {k: (0.5 * rng.standard_normal((1, 8, 16, 16))).astype(np.float32)
            for k in ("xz", "xy", "yz")}


def _head_bias_pair(model, tree, bias: float = 0.1):
    """The port model with a head bias, and the JAX params of the same
    decoder with that bias moved into lin_out's bias along the head (the
    JAX point kernel takes a zero head bias only)."""
    biased = copy.deepcopy(model)
    with torch.no_grad():
        biased.head_geo.fc.bias.fill_(bias)
    w_head = tree["head_geo"]["Dense_0"]["kernel"][:, 0].astype(np.float64)
    moved = jax.tree.map(np.asarray, tree)
    lin_out = moved["mlp"]["lin_out"]
    lin_out["bias"] = lin_out["bias"].copy()
    lin_out["bias"][:D_GEO] = (lin_out["bias"][:D_GEO] + bias * w_head / (w_head @ w_head)
                               ).astype(np.float32)
    return biased, {"params": jax.tree.map(jnp.asarray, moved), "batch_stats": {}}


def _close_to_kernel(ours: np.ndarray, ref: np.ndarray) -> float:
    err = np.abs(ours - ref)
    assert (err > 1e-4).mean() < 1e-2 and err.mean() < 1e-5 and err.max() < 5e-2, (
        (err > 1e-4).mean(), err.mean(), err.max())
    return float(err.mean())


def test_pack_point_weights_matches_jax(weights):
    jw, tw = weights
    as32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    d_in, d_code = 8, 39
    # the kernel's matrices, unpacked from their slabs in product order:
    # lin_in, then per block lin_z, w0, w1; the same bf16 values as JAX's,
    # JAX padding the inputs to 128 rows, the port to 16
    mats = [m.float().numpy() for m in unpack_decode_weights(tw)]
    assert [m.shape for m in mats] == [(16, 32)] + [(48, 32), (32, 32), (32, 32)] * NB
    np.testing.assert_array_equal(mats[0], as32(jw["w_in"])[:16])
    assert not as32(jw["w_in"])[d_in:].any() and not as32(jw["wz"])[:, d_code:].any()
    for b in range(NB):
        for m, ref in zip(mats[1 + 3 * b:4 + 3 * b], (as32(jw["wz"])[b, :48], jw["w0"][b], jw["w1"][b])):
            np.testing.assert_array_equal(m, as32(ref))
    np.testing.assert_array_equal(tw["k_w_last"].float().numpy(), as32(jw["w_last"])[:, 0])
    for name, ref in (("k_b_in", jw["b_in"][0]), ("k_bz", jw["bz"][:, 0]), ("k_b0", jw["b0"][:, 0]),
                      ("k_b1", jw["b1"][:, 0])):
        np.testing.assert_array_equal(tw[name].numpy(), as32(ref), err_msg=name)
    alpha, b_last, smoothing = np.asarray(jw["scal"][0])
    assert (tw["alpha"], np.float32(tw["b_last"]), tw["smoothing"]) == (alpha, b_last, smoothing)


@pytest.mark.parametrize("N", [256, 200, 1])  # a full tile pair, a ragged tail, one point
def test_plain_bf16_matches_pallas_interpret(weights, N):
    jw, tw = weights
    rng = np.random.default_rng(N)
    feat = rng.standard_normal((N, 8)).astype(np.float32)
    code = rng.standard_normal((N, 39)).astype(np.float32)
    ref = np.asarray(jfd.fused_resnetfc_tsdf(jnp.asarray(feat), jnp.asarray(code), jw, NB,
                                             tile=128, interpret=True))
    ours = pd.fused_resnetfc_tsdf_plain(_t(feat), _t(code), tw, bf16_feeds=True).numpy()
    mean_err = _close_to_kernel(ours, ref)
    # on the CPU the dispatching wrapper is the plain bf16-feed version
    np.testing.assert_array_equal(pd.fused_resnetfc_tsdf(_t(feat), _t(code), tw).numpy(), ours)
    f32 = pd.fused_resnetfc_tsdf_plain(_t(feat), _t(code), tw, bf16_feeds=False).numpy()
    if N > 1:
        assert np.abs(f32 - ref).mean() > 10 * mean_err


def test_plain_f32_matches_module_decode(task_pair, weights, planes):
    """Without bf16 feeds the plain version is the f32 ResnetFC + head."""
    _, tw = weights
    model = task_pair[-1]
    rng = np.random.default_rng(3)
    feat = _t(rng.standard_normal((1, 300, 8)).astype(np.float32))
    code = _t(rng.standard_normal((1, 300, 39)).astype(np.float32))
    with torch.no_grad():
        out = model.mlp(torch.cat([code, feat], dim=-1))
        ref = model.head_geo(out[..., :D_GEO])[0, :, 0]
    ours = pd.fused_resnetfc_tsdf_plain(feat[0], code[0], tw, bf16_feeds=False, chunk=128)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("normalize", [False, True])
def test_triplane_feat_fast(task_pair, planes, normalize):
    task, _, _, _, model = task_pair
    jmodel, tmodel = task.model, model
    if not normalize:
        cfg = dict(CFG, encoder=dict(CFG["encoder"], pointnet=dict(CFG["encoder"]["pointnet"],
                                                                   normalize_coords=False)))
        jmodel = GenNerfTask(cfg).model
        tmodel = GenNerf(config_from_dict(GenNerfConfig, cfg))
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.3, 1.6, (1, 500, 3)).astype(np.float32)
    setup_j = jpred._triplane_gather_setup(jmodel, {k: jnp.asarray(v) for k, v in planes.items()})
    setup_t = tpred.triplane_gather_setup(tmodel, {k: _t(v) for k, v in planes.items()})
    np.testing.assert_array_equal(setup_t[0].float().numpy(), np.asarray(setup_j[0], np.float32))
    ref = np.asarray(jpred._triplane_feat_fast(*setup_j, jnp.asarray(pts)))
    ours = tpred.triplane_feat_fast(*setup_t, _t(pts)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


def test_make_point_tsdf_fn_matches_jax(task_pair, planes):
    task, state, _, _, model = task_pair
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    repr_j = JRepr(None, None, {k: jnp.asarray(v) for k, v in planes.items()})
    jfn = jpred.make_point_tsdf_fn(task.model, variables, repr_j, np.zeros(3), tile=128,
                                   interpret=True)
    tfn = tpred.make_point_tsdf_fn(model, SceneRepr({k: _t(v) for k, v in planes.items()}))
    pts = np.random.default_rng(2).uniform(-0.3, 1.6, (1, 300, 3)).astype(np.float32)
    ours = tfn(_t(pts))
    assert ours.shape == (1, 300) and ours.dtype == torch.float32
    _close_to_kernel(ours.numpy(), np.asarray(jfn(jnp.asarray(pts))))
    # plain=True is the same plain version on the CPU
    plain = tpred.make_point_tsdf_fn(model, SceneRepr({k: _t(v) for k, v in planes.items()}),
                                     plain=True)
    np.testing.assert_array_equal(plain(_t(pts)).numpy(), ours.numpy())


@pytest.mark.parametrize("case", ["head_bias", "decoder", "planes", "channels", "sample_mode"])
def test_make_point_tsdf_fn_gates(task_pair, planes, case):
    """Each unsupported scene or decoder raises. A head bias is supported
    (it folds into b_last): the decode then holds against the JAX point
    kernel on the same decoder with the bias moved into lin_out, at the
    bounds of test_make_point_tsdf_fn_matches_jax."""
    task, _, _, tree, model = task_pair
    repr_planes = {k: _t(v) for k, v in planes.items()}
    if case == "head_bias":
        biased, variables = _head_bias_pair(model, tree)
        repr_j = JRepr(None, None, {k: jnp.asarray(v) for k, v in planes.items()})
        jfn = jpred.make_point_tsdf_fn(task.model, variables, repr_j, np.zeros(3), tile=128,
                                       interpret=True)
        pts = np.random.default_rng(5).uniform(-0.3, 1.6, (1, 300, 3)).astype(np.float32)
        ours = tpred.make_point_tsdf_fn(biased, SceneRepr(repr_planes))(_t(pts)).numpy()
        _close_to_kernel(ours, np.asarray(jfn(jnp.asarray(pts))))
        unbiased = tpred.make_point_tsdf_fn(model, SceneRepr(repr_planes))(_t(pts)).numpy()
        assert np.abs(ours - unbiased).max() > 1e-3
        return
    if case == "decoder":
        model = GenNerf(config_from_dict(GenNerfConfig, dict(CFG, mlp=dict(CFG["mlp"], beta=10.0))))
    elif case == "planes":
        del repr_planes["yz"]
    elif case == "channels":
        repr_planes = {k: torch.cat([v, v], dim=1) for k, v in repr_planes.items()}
    else:
        cfg = dict(CFG, encoder=dict(CFG["encoder"], pointnet=dict(CFG["encoder"]["pointnet"],
                                                                   sample_mode="nearest")))
        model = GenNerf(config_from_dict(GenNerfConfig, cfg))
    with pytest.raises(NotImplementedError):
        tpred.make_point_tsdf_fn(model, SceneRepr(repr_planes))


def test_decode_dense_fused_matches_composed_jax(task_pair, weights, planes):
    """JAX's decode_dense_fused runs on the TPU only, so its steps are
    composed here: map_features, the positional code, the interpret-mode
    point kernel."""
    task, state, _, _, model = task_pair
    jw, _ = weights
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    repr_j = JRepr(None, None, {k: jnp.asarray(v) for k, v in planes.items()})
    pts = np.random.default_rng(4).uniform(-0.2, 1.4, (333, 3)).astype(np.float32)
    feat = task.model.apply(variables, repr_j, jnp.asarray(pts)[None], jnp.zeros(3),
                            method=JGenNerf.map_features)[0]
    code = j_pe(jnp.asarray(pts), 6, 0.5, True)
    ref = np.asarray(jfd.fused_resnetfc_tsdf(feat, code, jw, NB, tile=128, interpret=True))
    ours = tpred.decode_dense_fused(model, SceneRepr({k: _t(v) for k, v in planes.items()}),
                                    _t(pts), chunk=100)
    assert ours.shape == (333,) and ours.dtype == torch.float32
    _close_to_kernel(ours.numpy(), ref)


def test_decode_dense_fused_gates(task_pair, planes):
    """Only CUDA and CPU points are taken; a head bias is (folded into
    b_last): the biased decode matches the unbiased model with the bias
    moved into lin_out, at the kernel bounds."""
    _, _, _, tree, model = task_pair
    repr_ = SceneRepr({k: _t(v) for k, v in planes.items()})
    with pytest.raises(NotImplementedError, match="CUDA or the CPU"):
        tpred.decode_dense_fused(model, repr_, torch.zeros(4, 3, device="meta"))
    biased, variables = _head_bias_pair(model, tree)
    moved = copy.deepcopy(model)
    moved.load_state_dict(gen_nerf_params_from_flax(jax.tree.map(np.asarray, variables["params"])))
    pts = _t(np.random.default_rng(6).uniform(-0.2, 1.4, (200, 3)).astype(np.float32))
    _close_to_kernel(tpred.decode_dense_fused(biased, repr_, pts).numpy(),
                     tpred.decode_dense_fused(moved, repr_, pts).numpy())


def test_point_decode_flops():
    # seqs_multigeo_4cm: c_dim 32, d_code 39, H 256, 5 blocks
    assert pd.point_decode_flops(1, 32, 39, 256, 5) == 1_427_456


def test_predict_tsdf_volume_sparse_matches_jax(task_pair, scene):
    """The band decode against JAX's, and against the dense gather decode
    clamped by the prior (both f32)."""
    task, state, _, _, model = task_pair
    P, image, depth = scene
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    rng = np.random.default_rng(9)
    planes = {k: (0.5 * rng.standard_normal((1, 8, 16, 16))).astype(np.float32)
              for k in ("xz", "xy", "yz")}
    origin = np.zeros(3, np.float32)
    ref = jpred.predict_tsdf_volume_sparse(
        task.model, variables, JRepr(None, None, {k: jnp.asarray(v) for k, v in planes.items()}),
        VOXEL_DIM, 0.08, origin, jnp.asarray(P), jnp.asarray(depth), chunk_size=256)
    repr_t = SceneRepr({k: _t(v) for k, v in planes.items()})
    ours = tpred.predict_tsdf_volume_sparse(model, repr_t, VOXEL_DIM, 0.08, _t(origin), _t(P),
                                            _t(depth), chunk_size=256)
    assert ours.shape == VOXEL_DIM and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    dense = tpred.decode_dense(model, repr_t, tpred.dense_grid_points(VOXEL_DIM, 0.08, _t(origin)))
    clamped = apply_fusion_prior(dense.reshape(VOXEL_DIM), 0.08, _t(origin), _t(P), _t(depth))
    np.testing.assert_allclose(ours.numpy(), clamped.numpy(), atol=1e-5, rtol=0)
    band = (ours.abs() < 1).sum()
    assert 0 < band < ours.numel()


def test_reconstruct_sparse_band_decode_matches_jax(task_pair, scene):
    """`sparse_band_decode` dispatches reconstruct to the band decode, as
    GenNerfTask.reconstruct does; same volume within the tolerance of the
    dense reconstruct test (1e-4: f32 encode and decode in another order)."""
    _, state, batch, _, model = task_pair
    P, image, depth = scene
    cfg = dict(CFG, sparse_band_decode=True)
    with jax.default_matmul_precision("highest"):
        pred, _ = GenNerfTask(cfg).reconstruct(state, batch)
    sparse_model = GenNerf(config_from_dict(GenNerfConfig, cfg))
    sparse_model.load_state_dict(model.state_dict())
    sel, start = _jax_draws(2, 12 * 16, 64)
    ours = reconstruct(sparse_model.eval(), P, image, depth, sel=sel, start=start)
    np.testing.assert_allclose(ours.numpy(), np.asarray(pred.tsdf_vol), atol=1e-4, rtol=0)
    dense = reconstruct(model, P, image, depth, sel=sel, start=start)
    np.testing.assert_allclose(ours.numpy(), dense.numpy(), atol=1e-4, rtol=0)
