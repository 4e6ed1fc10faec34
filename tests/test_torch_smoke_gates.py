"""chip_smoke.py's gate margins and breakdowns on the CPU, on small
synthetic inputs.

- `gate_margin` and `Gates`: each kind's margin (an upper bound, an
  agreement share, a lower bound, a strict lower bound for a control or a
  planted fault; exact gates and NaN), pass and fail at the edge, the
  phase's name on each gate, the `gates` line (the worst first, those at
  EDGE of their limit), `at_edge`; `reference_k2_gates` on the pinned and
  the unexplained errors.
- The K3 march breakdown: `march_breakdown` classifies each ray by the
  first pick the two marches make otherwise (coarse, fine, secant, none)
  and measures the plain value's distance from zero there in bf16 steps;
  `location_shares`; `pinned_tsdf` takes the plain pick only within a
  step; `march_trace` reads back what a march read; `march_analysis` on a
  tiny GenNerf whose "kernel" field is the plain field with a pick flipped
  near zero explains the rays that differ, pins them and leaves the
  kernel counters as they were, and does no work on marches that agree.
- `point_decode_reordered` (the control decode) against the plain
  bf16-feed decode; `depth_error_breakdown` (the oracle's AbsRel by where
  the rendered surface lies).
- The K2 breakdown: `bf16_tie_ulps` (0 on a rounding tie, 2^15 on a bf16
  value), `error_breakdown` (quantiles, the worst voxels by x-slab, tile and
  tile row), `grid_decode_reordered` against the plain bf16-feed decode,
  `k2_analysis` on a plain decode with one voxel perturbed,
  `k2_pinned_error` explaining one rounding flipped at a tie and not a
  perturbation.
- `ReluPicks.rows` (one rank's rows of every pick), `distance_distribution`
  and `parse_phases`.
- The `kernels` phase's table: each row builds its inputs at its tiny shape
  and runs its plain version there.
"""
import math
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from gennerf_tpu_torch.models.config import GenNerfConfig, config_from_dict
from gennerf_tpu_torch.models.gen_nerf import GenNerf
from gennerf_tpu_torch.ops.grid_decode import (
    GridTables, extract_resnetfc_weights, separable_grid_decode_plain,
)
from gennerf_tpu_torch.ops import kernels
from gennerf_tpu_torch.ops.point_decode import fused_resnetfc_tsdf_plain, pack_point_weights
from gennerf_tpu_torch.ops.weight_slabs import pack_decode_weights
from gennerf_tpu_torch.render import render_encoded
from gennerf_tpu_torch.train import predict as predict_module
from gennerf_tpu_torch.data.synthetic import ring_frames

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


# -- gates --------------------------------------------------------------------------------

@pytest.mark.parametrize("value,limit,kind,margin,ok", [
    (0.02, 0.05, "max", 0.4, True),
    (0.05, 0.05, "max", 1.0, True),
    (0.06, 0.05, "max", 1.2, False),
    (0.9913, 0.99, "agree", 0.87, True),
    (0.98, 0.99, "agree", 2.0, False),
    (1.0, 0.99, "agree", 0.0, True),
    (25.0, 22.0, "min", 0.88, True),
    (20.0, 22.0, "min", 1.1, False),
    (10.0, 5.0, "beyond", 0.5, True),
    (5.0, 5.0, "beyond", 1.0, False),
    (0, 0, "max", 0.0, True),
    (3, 0, "max", math.inf, False),
    (1.0, 1.0, "agree", 0.0, True),
    (math.nan, 1.0, "max", math.inf, False),
    (25.0, 22.0, "min_db", 10 ** -0.3, True),
    (21.0, 22.0, "min_db", 10 ** 0.1, False),
])
def test_gate_margin_and_pass(value, limit, kind, margin, ok):
    assert chip_smoke.gate_margin(value, limit, kind) == pytest.approx(margin)
    gates = chip_smoke.Gates()
    gates.phase = "render"
    assert gates.check("k3_march.depth_agree", value, limit, kind) is ok
    (rec,) = gates.records
    assert rec["name"] == "render.k3_march.depth_agree" and rec["kind"] == kind
    assert rec["margin"] == ("inf" if math.isinf(margin) else pytest.approx(margin))


def test_gates_line_lists_the_worst_first():
    gates = chip_smoke.Gates()
    gates.phase = "grid_decode"
    gates.check("k2.max_abs", 0.01, 0.05)
    gates.check("k2.mean_abs", 9e-4, 1e-3)
    gates.phase = "parallel"
    gates.check("planted.over_bound", 192.0, 1.0, "beyond")
    gates.check("index_mismatches", 1, 0)
    line = gates.line()
    assert line["phase"] == "gates" and line["count"] == 4 and len(line["gates"]) == 4
    assert [w[0] for w in line["worst"]] == ["parallel.index_mismatches",
                                             "grid_decode.k2.mean_abs", "grid_decode.k2.max_abs",
                                             "parallel.planted.over_bound"]
    assert line["at_least_0.8"] == ["parallel.index_mismatches", "grid_decode.k2.mean_abs"]
    assert line["worst"][0][1] == "inf"
    with pytest.raises(ValueError, match="unknown gate kind"):
        chip_smoke.gate_margin(1, 2, "between")


def test_at_edge():
    assert chip_smoke.at_edge(0.1, chip_smoke.EDGE)
    assert not chip_smoke.at_edge(0.1, 0.79)
    assert not chip_smoke.at_edge()
    assert chip_smoke.at_edge(math.inf)


@pytest.mark.parametrize("pinned,unexplained,ok,failing", [
    (0.0069, 0.004, True, []),
    (0.03, 0.004, False, ["max_abs_pinned"]),
    (0.0069, 0.06, False, ["unexplained_max_abs"]),
    (0.06, 0.004, False, ["max_abs", "max_abs_pinned"]),
])
def test_reference_k2_gates(pinned, unexplained, ok, failing):
    """The raw max error is not gated; the pinned one at both limits, the
    unexplained voxels' raw error at the grid limit."""
    saved = chip_smoke.GATES
    chip_smoke.GATES = chip_smoke.Gates()
    chip_smoke.GATES.phase = "weights_options"
    try:
        rec = {"max_abs": pinned, "unexplained_max_abs": unexplained}
        assert chip_smoke.reference_k2_gates("reference_ckpt_k2", 0.0499, 4e-4, rec) is ok
        records = {r["name"].split(".", 2)[2]: r for r in chip_smoke.GATES.records}
    finally:
        chip_smoke.GATES = saved
    assert set(records) == {"max_abs", "mean_abs", "max_abs_pinned", "unexplained_max_abs"}
    assert records["max_abs"]["value"] == pinned
    assert records["max_abs_pinned"]["limit"] == chip_smoke.REFERENCE_K2_PINNED_TOL
    assert sorted(k for k, r in records.items() if r["value"] > r["limit"]) == failing


# -- the K3 march's breakdown -------------------------------------------------------------

def _trace(coarse, fine, secant):
    return {"coarse": np.array(coarse, np.float32), "fine": np.array(fine, np.float32),
            "secant": np.array(secant, np.float32)}


def test_march_breakdown_classifies_by_the_first_flipped_pick():
    step = 1.0 / 256
    plain = _trace(
        [[-0.5, -0.2, 0.3, 0.6], [-0.5, 0.006, 0.3, 0.6], [-0.5, -0.2, 0.3, 0.6],
         [-0.5, -0.2, 0.3, 0.6], [-0.5, -0.2, 0.3, 0.6]],
        [[-0.2, -0.01, 0.1], [-0.2, -0.01, 0.1], [-0.2, -0.001, 0.1],
         [-0.2, -0.01, 0.1], [-0.2, -0.01, 0.1]],
        [[0.002, -0.001], [0.001, 0.001], [0.001, 0.001], [-0.0005, 0.002], [0.001, 0.0001]])
    kernel = _trace(
        # ray 0: the same everywhere but the secant's values (interpolation);
        # ray 1: the coarse sample at 0.006 (1.5 steps) read negative (a
        # bracket earlier);
        # ray 2: a fine sample at -0.001 read positive; ray 3: the first
        # secant value's sign; ray 4: the same picks
        [[-0.5, -0.2, 0.3, 0.6], [-0.5, -0.001, 0.3, 0.6], [-0.5, -0.2, 0.3, 0.6],
         [-0.5, -0.2, 0.3, 0.6], [-0.5, -0.2, 0.3, 0.6]],
        [[-0.2, -0.01, 0.1], [-0.2, -0.01, 0.1], [-0.2, 0.0005, 0.1],
         [-0.2, -0.01, 0.1], [-0.2, -0.01, 0.1]],
        [[0.0021, -0.001], [0.001, 0.001], [0.001, 0.001], [0.0004, 0.002], [0.001, 0.0001]])
    summary, causes = chip_smoke.march_breakdown(kernel, plain, step)
    assert list(causes) == ["interpolation", "coarse_pick", "fine_pick", "secant_pick",
                            "interpolation"]
    assert summary["rays"] == 5
    assert summary["by_cause"] == {"coarse_pick": 1, "fine_pick": 1, "secant_pick": 1,
                                   "interpolation": 2}
    near = sorted([0.006 / step, 0.001 / step, 0.0005 / step])
    assert summary["flipped_abs_tsdf_steps"]["1.0"] == pytest.approx(near[-1], rel=1e-5)
    assert summary["flipped_abs_tsdf_steps"]["0.5"] == pytest.approx(near[1], rel=1e-5)
    assert summary["flipped_within_one_step"] == pytest.approx(2 / 3)
    assert summary["kernel_err_steps_at_flip"]["1.0"] == pytest.approx(0.007 / step, rel=1e-4)


def test_location_shares():
    rec = chip_smoke.location_shares(silhouette=[True, False, False, True],
                                     crossing_index=[0, 7, 14, -1], samples=16,
                                     cosine=[0.1, 0.9, -0.2, math.nan])
    assert rec == {"rays": 4, "silhouette": 0.5, "box_clip": 0.5, "grazing": pytest.approx(2 / 3)}


def test_pinned_tsdf_takes_the_plain_pick_within_a_step():
    step = 0.01
    k = torch.tensor([[0.004, -0.003, 0.02, -0.5, 0.0, 0.3]])
    p = torch.tensor([[-0.002, 0.001, -0.015, 0.4, -0.001, 0.2]])
    fn = chip_smoke.pinned_tsdf(torch, lambda _: k, lambda _: p, step)
    out = fn(None)
    # flipped within a step: the plain pick with the kernel's magnitude (the
    # plain one's where the kernel reads 0); beyond a step or the same
    # pick: the kernel's value
    assert torch.equal(out, torch.tensor([[-0.004, 0.003, 0.02, -0.5, -0.001, 0.3]]))
    assert torch.equal(out < 0, torch.tensor([[True, False, False, True, True, False]]))


CFG = {
    "type": "GenNerf", "voxel_size": 0.08, "sampling_mode": "ray",
    "voxel_dim_train": [16, 16, 8], "voxel_dim_val": [16, 16, 8], "voxel_dim_test": [40, 40, 20],
    "encoder": {"use_spatial": False, "use_pointnet": True,
                "pointnet": {"num_sparse_points": 32, "fps_presample": 64,
                             "normalize_coords": True, "c_dim": 8, "hidden_dim": 8,
                             "plane_resolution": 16, "n_blocks": 2, "unet": False}},
    "mlp": {"d_out_sem": 1, "d_out_geo": 8, "n_blocks": 2, "d_hidden": 32, "alpha": 0.7},
    "code": {"num_freqs": 6, "freq_factor": 0.5, "include_input": True},
    "optimizer": {"type": "Adam", "lr": 0.001, "weight_decay": 0.0001},
}


@pytest.fixture(scope="module")
def scene():
    """A tiny GenNerf (random weights), its encode of 2 ring frames of
    12x16 and its field centred on the test box (so that it crosses zero
    there)."""
    torch.manual_seed(0)
    model = GenNerf(config_from_dict(GenNerfConfig, CFG)).eval()
    P, image, depth, intrinsics, pose = (torch.from_numpy(a) for a in ring_frames(
        2, 12, 16, (1.6, 1.6, 0.4), chip_smoke.PRIMITIVES, seed=0, cameras=True))
    with torch.no_grad():
        repr_ = model.encode(P[None], image[None], depth[None], torch.Generator().manual_seed(0))
        box = model.cfg.voxel_dim_test
        pts = torch.stack(torch.meshgrid(*[(torch.arange(n) + 0.5) * model.cfg.voxel_size
                                           for n in box], indexing="ij"), -1).reshape(-1, 3)
        chip_smoke.center_field(torch, model, repr_, pts)
    return model, repr_, depth, intrinsics, pose


def test_march_trace_reads_back_the_march(scene):
    model, repr_, depth, intrinsics, pose = scene
    tsdf = predict_module.make_point_tsdf_fn(model, repr_, plain=True)
    ref = render_encoded(model, repr_, depth, intrinsics, pose, tsdf, 1)
    rays = np.array([0, 5, 77, 191])
    K, P = intrinsics[:1], pose[:1]
    tr = chip_smoke.march_trace(torch, model, tsdf, K, P, 12, 16, rays)
    assert tr["coarse"].shape == (4, 16) and tr["fine"].shape == (4, 8)
    assert tr["secant"].shape == (4, 4)
    np.testing.assert_array_equal(tr["depth"], ref["ray_depth"][0].reshape(-1)[rays])


def test_march_analysis_explains_a_flipped_pick(scene):
    model, repr_, depth, intrinsics, pose = scene
    step = model.cfg.mlp.head_smoothing * chip_smoke.BF16_REL_STEP
    real = predict_module.make_point_tsdf_fn

    def flipping(model_, repr__, plain=False):
        fn = real(model_, repr__, plain=True)
        if plain:
            return fn

        def kernel(pts):  # every value within half a step of zero reads the other sign
            v = fn(pts)
            return torch.where(v.abs() < step / 2, -v - torch.sign(v) * 1e-7, v)
        return kernel

    with mock.patch.object(predict_module, "make_point_tsdf_fn", flipping):
        rk = render_encoded(model, repr_, depth, intrinsics, pose, flipping(model, repr_), 2)
        rp = render_encoded(model, repr_, depth, intrinsics, pose,
                            flipping(model, repr_, plain=True), 2)
        before = {k.name: k.launches for k in kernels.KERNELS}
        rec = chip_smoke.march_analysis(torch, model, repr_, depth, intrinsics, pose, rk, rp)
    assert {k.name: k.launches for k in kernels.KERNELS} == before
    assert rec["rays"] == 2 * 12 * 16 and rec["differing_rays"] >= 1
    diff = rec["differing"]
    assert diff["rays"] == rec["differing_rays"]
    assert diff["by_cause"]["interpolation"] < diff["rays"]
    assert diff["flipped_within_one_step"] == 1.0
    assert diff["flipped_abs_tsdf_steps"]["1.0"] <= 0.5
    assert set(diff["where"]) == {"rays", "silhouette", "box_clip", "grazing"}
    assert "agreeing_sample" in rec
    # pinned to the plain march's picks within a step, the march is the plain one
    assert rec["pinned"]["vs_plain_mask_agree"] == 1.0
    assert rec["pinned"]["vs_plain_depth_agree"] == 1.0
    # the control (float64 sums of the same bf16 products) marches as the plain decode
    assert rec["control_float64_sums"]["vs_plain_mask_agree"] >= 0.99
    # marches that agree are far from the gates' edge: nothing is traced
    with mock.patch.object(chip_smoke, "march_trace", side_effect=AssertionError):
        assert chip_smoke.march_analysis(torch, model, repr_, depth, intrinsics, pose,
                                         rp, rp) is None


def test_point_decode_reordered_rounds_as_the_plain_decode(grid):
    _, w = grid
    pw = pack_point_weights(w)
    g = torch.Generator().manual_seed(4)
    feat, code = torch.randn(300, 8, generator=g), torch.randn(300, 39, generator=g)
    plain = fused_resnetfc_tsdf_plain(feat, code, pw, bf16_feeds=True)
    f32 = fused_resnetfc_tsdf_plain(feat, code, pw, bf16_feeds=False)
    control = chip_smoke.point_decode_reordered(torch, feat, code, pw, chunk=128)
    assert control.shape == (300,) and control.dtype == torch.float32
    assert float((control - plain).abs().max()) < 0.1 * float((f32 - plain).abs().max())


def test_depth_error_breakdown():
    trgt = np.array([[1.0, 1.0, 2.0, 0.0], [2.0, 1.0, 1.0, 1.0]])
    pred = np.array([[1.02, 1.5, 2.0, 1.0], [1.8, 0.0, 1.0, 1.01]])
    rec = chip_smoke.depth_error_breakdown([pred[:1], pred[1:]], [trgt[:1], trgt[1:]])
    # 6 pixels with a depth in both; one 0.5 m behind, one 0.2 m in front
    assert rec["pixels"] == 6
    assert rec["behind"]["share"] == pytest.approx(1 / 6)
    assert rec["in_front"]["share"] == pytest.approx(1 / 6)
    rel = np.array([0.02, 0.5, 0.0, 0.1, 0.0, 0.01])
    assert rec["abs_rel"] == pytest.approx(rel.mean())
    assert rec["behind"]["abs_rel_share"] == pytest.approx(0.5 / rel.sum())
    assert rec["within"]["abs_rel_share"] == pytest.approx(0.03 / rel.sum())
    assert chip_smoke.depth_error_breakdown(pred, trgt) == rec


# -- the K2 breakdown ---------------------------------------------------------------------

def test_bf16_tie_ulps():
    bf16_value = torch.tensor([1.5, 3.0, 0.0])
    tie = (torch.tensor([0x3FC08000], dtype=torch.int32)).view(torch.float32)  # 1.50390625
    near_tie = (torch.tensor([0x3FC08003, 0x3FC07FF0], dtype=torch.int32)).view(torch.float32)
    got = chip_smoke.bf16_tie_ulps(torch, torch.cat([bf16_value, tie, near_tie]))
    assert got.tolist() == [1 << 15, 1 << 15, 1 << 15, 0, 3, 16]


def test_error_breakdown_finds_one_slab():
    err = np.full((4, 8, 32), 1e-4)
    err[2, 3, 5:21] = 0.03  # 16 voxels of x-slab 2, rows 101..116 of tile 4 ... of 256 per slab
    out = np.ones_like(err)
    rec = chip_smoke.error_breakdown(err, out, tile=128, top=16)
    assert rec["voxels"] == err.size
    assert rec["quantiles"]["1.0"] == pytest.approx(0.03)
    assert rec["share_over_1e-2"] == pytest.approx(16 / err.size)
    assert rec["max_over_out_abs_max"] == pytest.approx(0.03)
    assert rec["top_x_slabs"] == {"distinct": 1, "most_in_one": 16}
    assert rec["top_tiles"] == {"distinct": 1, "most_in_one": 16}
    assert rec["top_tile_rows"] == {"at_tile_edge": 0, "at_consumer_split": 0}


@pytest.fixture(scope="module")
def grid():
    """Random tables and weights of a ResnetFC at H 32, 2 blocks, on an
    8x6x5 grid."""
    g = torch.Generator().manual_seed(3)
    model = GenNerf(config_from_dict(GenNerfConfig, CFG))
    with torch.no_grad():
        for p in model.mlp.parameters():
            if p.dim():
                p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(p.shape[-1]))
    w = pack_decode_weights(extract_resnetfc_weights(
        model.mlp, model.head_geo, model.cfg.mlp.d_out_geo, model.cfg.mlp.head_smoothing),
        point=False)
    nx, ny, nz, H, nb = 8, 6, 5, 32, 2
    tables = GridTables(*(torch.randn(s, generator=g) for s in (
        (ny * nz, H), (nx, nz, H), (nx, ny, H), (nx, nb, H), (nb, ny, H), (nb, nz, H))))
    return tables, w


def test_grid_decode_reordered_rounds_as_the_plain_decode(grid):
    tables, w = grid
    plain = separable_grid_decode_plain(tables, w, bf16_feeds=True)
    f32 = separable_grid_decode_plain(tables, w, bf16_feeds=False)
    control, ties = chip_smoke.grid_decode_reordered(torch, tables, w, points=[0, 17, 239])
    assert control.shape == plain.shape == (8, 6, 5)
    # another summation order of the same bf16 products: far nearer the
    # plain bf16-feed decode than the float32 decode is
    assert float((control - plain).abs().max()) < 0.1 * float((f32 - plain).abs().max())
    assert len(ties) == 3
    sites = {f"block{b}.{p}" for b in range(2) for p in ("first", "second")} | {"head"}
    assert all(0 <= u <= 1 << 15 and site in sites for u, site in ties)


def test_k2_pinned_error_explains_one_flipped_rounding(grid):
    """A "kernel" output that rounds one activation of one voxel (its one
    nearest a bf16 tie) the other way: the plain error there is pinned to
    the float64-sum decode with that rounding flipped; an error no single
    rounding makes stays (less what the nearest flip moves)."""
    tables, w = grid
    plain = separable_grid_decode_plain(tables, w, bf16_feeds=True)

    def flipped_voxel():
        # the first live voxel whose nearest-tie rounding, flipped, moves it
        for v in range(plain.numel()):
            if abs(float(plain.reshape(-1)[v])) > 0.9:
                continue
            x, zx = chip_smoke._grid_inputs(torch, tables, [v])
            sites = []
            base = chip_smoke._grid_tail(torch, w, x, zx, sites=sites)
            ties = torch.stack([chip_smoke.bf16_tie_ulps(torch, a) for a in sites], 1)
            nearest = int(torch.argmin(ties.reshape(-1)))
            flips = (torch.tensor([nearest // 32]), torch.tensor([nearest % 32]))
            moved = chip_smoke._grid_tail(torch, w, x, zx, flips=flips)
            if abs(float(moved[0] - base[0])) > 1e-4:
                return v, float(moved[0])
        raise AssertionError("no rounding flip moves a voxel")

    v, moved = flipped_voxel()
    out = plain.clone().reshape(-1)
    out[v] = moved
    out = out.reshape(plain.shape)
    assert float((out - plain).abs().max()) > 1e-4
    rec = chip_smoke.k2_pinned_error(torch, tables, w, out, plain, tol=0.0)
    assert rec["max_abs_plain"] == pytest.approx(float((out - plain).abs().max()))
    assert rec["max_abs"] < 1e-5 and rec["examined"] >= 1 and rec["explained"] >= 1
    assert rec["unexplained_max_abs"] < 1e-4
    # a 0.03 error on another voxel: a rounding flip there moves it by a
    # few thousandths at most, so it stays near 0.03
    out.reshape(-1)[(v + 1) % out.numel()] += 0.03
    rec = chip_smoke.k2_pinned_error(torch, tables, w, out, plain, tol=0.0)
    assert 0.02 < rec["max_abs"] <= 0.03 + 1e-6
    assert rec["unexplained_max_abs"] == pytest.approx(float((out - plain).abs().max()))


def test_k2_analysis_on_a_perturbed_decode(grid):
    tables, w = grid
    plain = separable_grid_decode_plain(tables, w, bf16_feeds=True)
    out = plain.clone()
    out[3, 2, 1] += 0.02
    rec = chip_smoke.k2_analysis(torch, tables, w, out, plain, top=4)
    assert rec["kernel"]["quantiles"]["1.0"] == pytest.approx(0.02, rel=1e-4)
    assert rec["kernel"]["top_x_slabs"]["distinct"] >= 1
    assert rec["control_float64_sums"]["quantiles"]["1.0"] < 0.02
    assert rec["bf16_feeds_vs_f32"]["max_abs"] > 0
    assert set(rec["nearest_tie_ulps"]) == {"worst", "random", "worst_sites"}
    assert sum(rec["nearest_tie_ulps"]["worst_sites"].values()) == 4


# -- the parallel phase's helpers, the phase selection -------------------------------------

def test_relu_picks_rows():
    picks = chip_smoke.ReluPicks(torch)
    picks.picks = [torch.arange(16).reshape(16, 1) > 3, torch.arange(4 * 3).reshape(4, 3)]
    r1 = picks.rows(1, 2)
    assert [p.shape[0] for p in r1.picks] == [8, 2]
    assert torch.equal(r1.picks[1], torch.tensor([[6, 7, 8], [9, 10, 11]]))
    assert r1.modules is picks.modules


def test_distance_distribution():
    ref = {"grads": {"a": torch.tensor([1.0, -2.0]), "b": torch.tensor([4.0])}}
    runs = [{"grads": {"a": torch.tensor([1.0, -2.2]), "b": torch.tensor([4.0])}},
            {"grads": {"a": torch.tensor([1.1, -2.0]), "b": torch.tensor([4.4])}}]
    others = [{"grads": {"a": torch.tensor([1.0, -2.0]), "b": torch.tensor([4.2])}}]
    rec = chip_smoke.distance_distribution(runs, others, ref, top=1)
    assert rec["parameters"] == 2
    assert rec["quantiles"]["1.0"] == pytest.approx(0.1)
    assert rec["top"][0][0] in ("a", "b") and rec["top"][0][1] == pytest.approx(0.1)


def test_parse_phases():
    assert chip_smoke.parse_phases([]) == set(chip_smoke.PHASES)
    assert chip_smoke.parse_phases(["--phases", "weights_options,parallel"]) == {
        "weights_options", "parallel"}
    assert chip_smoke.parse_phases(["--phases", ""]) == set()
    with pytest.raises(SystemExit):
        chip_smoke.parse_phases(["--phases", "render"])


@pytest.mark.parametrize("row", chip_smoke.KERNEL_ROWS, ids=lambda row: row.name)
def test_kernel_row_runs_its_plain_version_at_a_tiny_shape(row, monkeypatch):
    """Each row at its tiny shape: the plain call's output finite, and the
    row's check passing that output as the kernel's (the kernels its check
    calls again replaced by their plain versions)."""
    from gennerf_tpu_torch.ops import interpolation, spatial_lift

    monkeypatch.setattr(spatial_lift, "spatial_lift_cuda", spatial_lift.spatial_lift_plain)
    monkeypatch.setattr(interpolation, "trilinear_interpolation_cuda",
                        interpolation.trilinear_interpolation_plain)
    x = row.make(torch, torch.device("cpu"), row.tiny)
    out = x["plain"]()
    assert all(torch.isfinite(t.float()).all() for t in (out if isinstance(out, list) else [out]))
    assert x["bytes"] > 0 and x["ops"] >= 0 and len(row.tiny) == len(row.shape)
    checks = x["check"](out, out)
    assert checks and all(value <= limit for value, limit in checks.values()), checks
    assert chip_smoke._max_abs(out, out) == 0.0
    # the gather times one part a resized map; the backprojection one part,
    # its kernel alone on channels_last features; every other row its kernel
    parts = len(row.tiny[1]) - 1 if row.name == "lift_resize_t" else 1
    assert len(x.get("parts", [None])) == parts
