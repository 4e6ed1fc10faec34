"""Parity of the port's separable grid decode (gennerf_tpu_torch.ops.grid_decode)
with gennerf_tpu/ops/pallas/fused_decoder.py on the CPU, at H=32 with 2
blocks.

- weight packing and the axis tables agree with the JAX build within
  rtol 1e-5 (f32, another summation order);
- the plain decode with bf16_feeds=False agrees with
  separable_grid_decode_xla(use_bf16=False) within 1e-5;
- the plain decode with bf16_feeds=True agrees with the Pallas grid kernel
  run in interpret mode at all but a few points: fewer than 0.1% of points
  differ by more than 1e-4, the mean difference is under 1e-5 and the
  largest under 5e-2. Both round every product input to bf16 and
  accumulate in f32, but in another order, so an activation within an ulp
  of a bf16 rounding boundary can round the other way (one bf16 step is
  2^-8 of the value) and carry that step through the remaining blocks
  (seeds 0-2 give at most 12 of 16384 points above 1e-4, largest 0.026).
  The f32 decode is more than 100x further from the kernel on average.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu.models.heads import TSDFHeadSimple as JHead
from gennerf_tpu.models.resnetfc import ResnetFC as JResnetFC
from gennerf_tpu.ops.pallas import fused_decoder as jfd
from gennerf_tpu_torch.models.heads import TSDFHeadSimple
from gennerf_tpu_torch.models.resnetfc import ResnetFC
from gennerf_tpu_torch.ops import grid_decode as gd

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

D_IN, D_CODE, H, NB, RESO = 8, 39, 32, 2, 16
PE = dict(num_freqs=6, freq_factor=0.5, include_input=True, padding=0.1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True)
def _f32_highest():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def decoder():
    """JAX ResnetFC + head params (Dense_1 randomized, alpha 0.7, smoothing
    1.05), the JAX packed weights, and the port's packed weights."""
    rng = np.random.default_rng(11)
    zx = jnp.asarray(rng.standard_normal((4, D_IN + D_CODE)).astype(np.float32))
    mlp_j = JResnetFC(d_in=D_IN, d_out=9, n_blocks=NB, d_latent=D_CODE, d_hidden=H, alpha=0.7)
    params = jax.tree.map(np.asarray, dict(mlp_j.init(jax.random.PRNGKey(0), zx)["params"]))
    for b in range(NB):
        blk = params[f"block_{b}"]["Dense_1"]
        blk["kernel"] = (0.2 * rng.standard_normal((H, H))).astype(np.float32)
        blk["bias"] = (0.1 * rng.standard_normal(H)).astype(np.float32)
    params["alpha"] = np.asarray(0.7, np.float32)
    head = jax.tree.map(np.asarray, dict(JHead(smoothing=1.05).init(jax.random.PRNGKey(1), zx[:, :8])["params"]))
    jw = jfd.extract_resnetfc_weights(params, head, NB, 8, head_smoothing=1.05)

    mlp_t = ResnetFC(D_IN, 9, NB, D_CODE, H, alpha=0.7)
    head_t = TSDFHeadSimple(8, smoothing=1.05)
    with torch.no_grad():
        mlp_t.lin_in.weight.copy_(_t(params["lin_in"]["kernel"].T))
        mlp_t.lin_in.bias.copy_(_t(params["lin_in"]["bias"]))
        mlp_t.lin_out.weight.copy_(_t(params["lin_out"]["kernel"].T))
        mlp_t.lin_out.bias.copy_(_t(params["lin_out"]["bias"]))
        mlp_t.alpha.fill_(0.7)
        for b in range(NB):
            mlp_t.lin_z[b].weight.copy_(_t(params[f"lin_z_{b}"]["kernel"].T))
            mlp_t.lin_z[b].bias.copy_(_t(params[f"lin_z_{b}"]["bias"]))
            for name, fc in (("Dense_0", mlp_t.blocks[b].fc_0), ("Dense_1", mlp_t.blocks[b].fc_1)):
                fc.weight.copy_(_t(params[f"block_{b}"][name]["kernel"].T))
                fc.bias.copy_(_t(params[f"block_{b}"][name]["bias"]))
        head_t.fc.weight.copy_(_t(head["Dense_0"]["kernel"].T))
        head_t.fc.bias.copy_(_t(head["Dense_0"]["bias"]))
    tw = gd.extract_resnetfc_weights(mlp_t, head_t, 8, head_smoothing=1.05)
    return jw, tw


@pytest.fixture
def planes(rng):
    return {k: (0.5 * rng.standard_normal((D_IN, RESO, RESO))).astype(np.float32)
            for k in ("xz", "xy", "yz")}


def test_extract_resnetfc_weights(decoder):
    jw, tw = decoder
    pairs = [("w_in", jw["w_in_raw"]), ("b_in", jw["b_in"][0]), ("wz", jw["wz_raw"]),
             ("bz", jw["bz_raw"]), ("w0", jw["w0_f32"]), ("w1", jw["w1_f32"]),
             ("b0", jw["b0"][:, 0]), ("b1", jw["b1"][:, 0]), ("w_last", jw["w_last_f32"][:, 0])]
    for name, ref in pairs:
        np.testing.assert_array_equal(tw[name].numpy(), np.asarray(ref, np.float32), err_msg=name)
    alpha, b_last, smoothing = np.asarray(jw["scal"][0])
    assert (tw["alpha"], np.float32(tw["b_last"]), tw["smoothing"]) == (alpha, b_last, smoothing)
    assert jw["b_head"] == 0.0  # b_last folds the head bias (zero here)
    # the bf16 kernel feeds are the same roundings of the same values
    np.testing.assert_array_equal(tw["w0"].to(torch.bfloat16).float().numpy(),
                                  np.asarray(jw["w0"].astype(np.float32)))
    np.testing.assert_array_equal(tw["w_last"].to(torch.bfloat16).float().numpy(),
                                  np.asarray(jw["w_last"][:, 0].astype(np.float32)))


def test_resample_matrix_and_plane(rng):
    u = rng.uniform(0, 1 - 1e-5, 20).astype(np.float32)
    np.testing.assert_allclose(gd.resample_matrix(_t(u), RESO).numpy(),
                               np.asarray(jfd._resample_matrix(jnp.asarray(u), RESO)), rtol=1e-5, atol=1e-7)
    plane = rng.standard_normal((4, RESO, RESO)).astype(np.float32)
    wh = np.asarray(jfd._resample_matrix(jnp.asarray(u[:7]), RESO))
    ww = np.asarray(jfd._resample_matrix(jnp.asarray(u[7:]), RESO))
    np.testing.assert_allclose(
        gd.resample_plane(_t(plane), _t(wh), _t(ww)).numpy(),
        np.asarray(jfd._resample_plane(jnp.asarray(plane), jnp.asarray(wh), jnp.asarray(ww))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_pe_axis_table(rng, axis):
    c = rng.uniform(-0.5, 3.0, 11).astype(np.float32)
    np.testing.assert_allclose(
        gd.pe_axis_table(_t(c), axis, 6, 0.5, True).numpy(),
        np.asarray(jfd._pe_axis_table(jnp.asarray(c), axis, 6, 0.5, True)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("normalized", [False, True])
def test_grid_tables(decoder, planes, normalized):
    jw, tw = decoder
    common = dict(voxel_dim=(8, 6, 10), voxel_size=0.08, **PE)
    if normalized:
        common.update(coord_center=(0.32, 0.24, 0.4), coord_scale=0.8)
    origin = np.array([0.02, -0.05, 0.01], np.float32)
    ref = jfd._grid_tables(*(jnp.asarray(planes[k]) for k in ("xz", "xy", "yz")),
                           jnp.asarray(origin), jw, **common)
    ours = gd.grid_tables(*(_t(planes[k]) for k in ("xz", "xy", "yz")), _t(origin), tw, **common)
    for name, o, r in zip(gd.GridTables._fields, ours, ref):
        assert o.shape == r.shape, name
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6, err_msg=name)


def test_plain_f32_matches_separable_xla(decoder, planes):
    jw, tw = decoder
    common = dict(voxel_dim=(16, 16, 8), voxel_size=0.08, **PE)
    origin = np.array([0.05, -0.1, 0.02], np.float32)
    ref = jfd.separable_grid_decode_xla(*(jnp.asarray(planes[k]) for k in ("xz", "xy", "yz")),
                                        jnp.asarray(origin), jw, n_blocks=NB, use_bf16=False, **common)
    tables = gd.grid_tables(*(_t(planes[k]) for k in ("xz", "xy", "yz")), _t(origin), tw, **common)
    ours = gd.separable_grid_decode_plain(tables, tw, bf16_feeds=False)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    # on the CPU the dispatching wrapper is the plain f32 version
    np.testing.assert_array_equal(gd.grid_decode(tables, tw).numpy(), ours.numpy())


def test_plain_bf16_matches_pallas_interpret(decoder, planes):
    """bf16-feed plain decode vs the TPU grid kernel in interpret mode, at a
    grid whose 16*64-point tile is legal for the TPU kernel."""
    jw, tw = decoder
    voxel_dim = (16, 16, 64)
    common = dict(voxel_dim=voxel_dim, voxel_size=0.08, **PE)
    origin = np.array([0.05, -0.1, 0.02], np.float32)
    tj = jfd.pick_grid_tile(16, 64)
    ref = jfd.fused_grid_decode(*(jnp.asarray(planes[k]) for k in ("xz", "xy", "yz")),
                                jnp.asarray(origin), jw, n_blocks=NB, tj=tj, interpret=True, **common)
    tables = gd.grid_tables(*(_t(planes[k]) for k in ("xz", "xy", "yz")), _t(origin), tw, **common)
    ours = gd.separable_grid_decode_plain(tables, tw, bf16_feeds=True).numpy()
    err = np.abs(ours - np.asarray(ref))
    assert (err > 1e-4).mean() < 1e-3 and err.mean() < 1e-5 and err.max() < 5e-2, (
        (err > 1e-4).mean(), err.mean(), err.max())
    # the bf16 feeds matter at this tolerance: the f32 decode is far away
    f32 = gd.separable_grid_decode_plain(tables, tw, bf16_feeds=False).numpy()
    assert np.abs(f32 - np.asarray(ref)).mean() > 100 * err.mean()


def test_head_bias_folds_into_b_last(decoder, planes):
    """A non-zero head bias (every trained model has one) folds into
    b_last. With it, the bf16-feed plain decode holds against the Pallas
    grid kernel in interpret mode at the zero-bias bounds above: the JAX
    kernel takes a zero head bias only, so it runs the equivalent weights
    with the bias moved into lin_out's bias along the head. The f32 plain
    decode holds against the JAX f32 separable decode of those weights
    within 1e-5, the bound of test_plain_f32_matches_separable_xla."""
    jw, _ = decoder
    rng = np.random.default_rng(3)
    mlp_t = ResnetFC(D_IN, 9, NB, D_CODE, H, alpha=0.7)
    head_t = TSDFHeadSimple(8, smoothing=1.05)
    with torch.no_grad():
        for p in list(mlp_t.parameters()) + list(head_t.parameters()):
            p.copy_(torch.from_numpy(np.asarray(0.2 * rng.standard_normal(p.shape), np.float32)))
        mlp_t.alpha.fill_(0.7)
        head_t.fc.bias.fill_(0.3)
    tw = gd.extract_resnetfc_weights(mlp_t, head_t, 8, head_smoothing=1.05)
    w_head = head_t.fc.weight[0].detach().double()
    b_out = mlp_t.lin_out.bias[:8].detach().double()
    b_head = float(head_t.fc.bias.detach().double()[0])  # 0.3 in f32
    assert tw["b_last"] == pytest.approx(float(b_out @ w_head) + b_head, abs=1e-12)
    # the JAX params of the same decoder with the head bias moved into lin_out
    moved = b_out + 0.3 * w_head / (w_head @ w_head)
    params = {"lin_in": {"kernel": mlp_t.lin_in.weight.T.detach().numpy(),
                         "bias": mlp_t.lin_in.bias.detach().numpy()},
              "lin_out": {"kernel": mlp_t.lin_out.weight.T.detach().numpy(),
                          "bias": np.concatenate([moved.float().numpy(),
                                                  mlp_t.lin_out.bias[8:].detach().numpy()])},
              "alpha": np.asarray(0.7, np.float32)}
    for b in range(NB):
        params[f"lin_z_{b}"] = {"kernel": mlp_t.lin_z[b].weight.T.detach().numpy(),
                                "bias": mlp_t.lin_z[b].bias.detach().numpy()}
        params[f"block_{b}"] = {
            name: {"kernel": fc.weight.T.detach().numpy(), "bias": fc.bias.detach().numpy()}
            for name, fc in (("Dense_0", mlp_t.blocks[b].fc_0), ("Dense_1", mlp_t.blocks[b].fc_1))}
    head = {"Dense_0": {"kernel": head_t.fc.weight.T.detach().numpy(), "bias": np.zeros(1, np.float32)}}
    params = jax.tree.map(lambda a: np.array(a, np.float32), params)
    jw2 = jfd.extract_resnetfc_weights(params, head, NB, 8, head_smoothing=1.05)
    voxel_dim = (16, 16, 64)
    common = dict(voxel_dim=voxel_dim, voxel_size=0.08, **PE)
    origin = np.array([0.05, -0.1, 0.02], np.float32)
    ref = jfd.fused_grid_decode(*(jnp.asarray(planes[k]) for k in ("xz", "xy", "yz")),
                                jnp.asarray(origin), jw2, n_blocks=NB, tj=jfd.pick_grid_tile(16, 64),
                                interpret=True, **common)
    tables = gd.grid_tables(*(_t(planes[k]) for k in ("xz", "xy", "yz")), _t(origin), tw, **common)
    ours = gd.separable_grid_decode_plain(tables, tw, bf16_feeds=True).numpy()
    err = np.abs(ours - np.asarray(ref))
    assert (err > 1e-4).mean() < 1e-3 and err.mean() < 1e-5 and err.max() < 5e-2, (
        (err > 1e-4).mean(), err.mean(), err.max())
    # f32: the plain decode is the module's ResnetFC and head at the grid points
    f32 = gd.separable_grid_decode_plain(tables, tw, bf16_feeds=False)
    ref32 = jfd.separable_grid_decode_xla(*(jnp.asarray(planes[k]) for k in ("xz", "xy", "yz")),
                                          jnp.asarray(origin), jw2, n_blocks=NB, use_bf16=False,
                                          **common)
    np.testing.assert_allclose(f32.numpy(), np.asarray(ref32), atol=1e-5, rtol=0)


def test_grid_decode_flops():
    assert gd.grid_decode_flops((96, 96, 56), 256, 5) == 516096 * (5 * 4 * 256 * 256 + 512)

