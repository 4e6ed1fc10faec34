"""The combined-encoder GenNerf cell (gennerf_living_spatial.recon: a
ResNet-34 feature volume beside the PointNet triplanes) at the tiny sizes
of portbench/tests/tiny.py on the CPU: the program against the cell's
plain reference in float32 and, in bf16-mixed, by the cell's limits; the
control and a zeroed volume failing those limits; the new spans and
counters and their readers; the request FLOPs against the reference's
counted ones; the reference importing nothing of the program or JAX."""
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from gennerf_tpu_torch.models import gen_nerf
from gennerf_tpu_torch.utils import spans
from portbench import run
from portbench.core import spec
from portbench.core.readers import Reading
from portbench.tests.tiny import cpu_ctx, tiny_gennerf

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

CELL = "gennerf_living_spatial.recon"
SEED = 2**33 + 29


@pytest.fixture(autouse=True)
def _fresh_counts():
    spans.reset()
    yield
    spans.reset()


def _values(res):
    return {k: c["value"] for k, c in res["checks"].items()}


def test_float32_program_agrees_with_the_reference():
    ctx = cpu_ctx(CELL, seed=SEED)
    ctx.cfg["precision"] = "32-true"
    ctx.limits = {"checks": {"band_rel_rms_gap": 1e-5, "prior_mismatches": 0,
                             "fps_bad_picks": 0}}
    res = run.run_cell(ctx)
    assert res["correct"], res["checks"]
    assert res["info"]["band_share"] > 0.05, res["info"]


def test_bf16_run_is_correct_by_the_cell_limits():
    ctx = cpu_ctx(CELL, seed=SEED + 1)
    assert ctx.cfg["precision"] == "bf16-mixed"
    assert set(ctx.limits["checks"]) == {"band_logit_rel_rms_gap", "prior_mismatches",
                                         "fps_bad_picks"}
    res = run.run_cell(ctx)
    assert res["correct"], res["checks"]


def _zeroed_volume(monkeypatch):
    real = gen_nerf.GenNerf.volume_features

    def zeroed(self, repr_):
        v = real(self, repr_)
        return None if v is None else torch.zeros_like(v)

    monkeypatch.setattr(gen_nerf.GenNerf, "volume_features", zeroed)


@pytest.mark.parametrize("case", ["control", "zeroed_volume"])
def test_the_cell_limits_fail_the_control_and_a_zeroed_volume(case, monkeypatch):
    ctx = cpu_ctx(CELL, seed=SEED + 2)
    if case == "control":
        d = ctx.driver
        st = d.prepare(ctx)
        evidence = d.control(ctx, st)
        d.release(st)
        checks = run.judge_checks(d.judge(ctx, st, evidence)["checks"], ctx.limits)
    else:
        _zeroed_volume(monkeypatch)
        checks = run.run_cell(ctx)["checks"]
    v = checks["band_logit_rel_rms_gap"]
    assert v["value"] > v["limit"], checks


def test_traced_run_counts_the_dense_decode_and_the_volume():
    ctx = cpu_ctx(CELL, seed=SEED + 3, seconds=0.3, trace=True)
    res = run.run_cell(ctx)
    voxels = 1
    for n in ctx.cfg["voxel_dim_test"]:
        voxels *= n
    c = spans.counters()
    assert c["decode.dense_points"] == res["attempted"] * voxels
    assert "decode.voxels" not in c
    assert c["volume.voxels"] == res["attempted"] * voxels
    assert 0 < c["volume.observed_voxels"] <= c["volume.voxels"]
    assert res["metrics"]["dense_decode_share.infer"]["value"] == 100.0
    share = res["metrics"]["volume_observed_share.infer"]["value"]
    assert share == pytest.approx(100.0 * c["volume.observed_voxels"] / c["volume.voxels"])
    assert 0.0 < share <= 100.0
    names = {name for name, _, _ in res["summary"]["cpu"]}
    assert {"gennerf.featurize", "gennerf.backproject", "gennerf.volume"} <= names

    # the idle reader on the run's own host spans, the device busy around each backprojection
    cpu = res["summary"]["cpu"]
    under = sorted((s, e) for name, s, e in cpu if name == "gennerf.backproject")
    assert len(under) == res["attempted"]
    t0, t1 = cpu[0][1] - 1.0, max(e for _, _, e in cpu) + 1.0
    edges = [t0] + [t for s, e in under for t in (s, e)] + [t1]
    ops = [(f"k{i}", edges[2 * i], edges[2 * i + 1] - edges[2 * i]) for i in range(len(under) + 1)]
    r = Reading(ctx.cfg, ctx.counts, {"device_ops": ops, "cpu": cpu}, 10.0, 1,
                {"requests": res["attempted"], "steps": 0, "items": 0})
    idle = spec.piece("metrics", "backproject_idle_ms.infer").read(r)
    want = sum(e - s for s, e in under) * 1e3 / res["attempted"]
    assert idle == pytest.approx(want)


def test_readers_without_their_counters_or_span_give_none():
    r = Reading({}, None, {"device_ops": [("k", 0.0, 1.0), ("k", 2.0, 1.0)],
                           "cpu": [("gennerf.reconstruct", 0.0, 3.0)]}, 10.0, 1,
                {"requests": 1, "steps": 0, "items": 0})
    for name in ("dense_decode_share.infer", "volume_observed_share.infer",
                 "backproject_idle_ms.infer"):
        assert spec.piece("metrics", name).read(r) is None, name
    with profile(activities=[ProfilerActivity.CPU]):
        spans.count("decode.voxels", 300)
        spans.count("decode.dense_points", 100)
    assert spec.piece("metrics", "dense_decode_share.infer").read(r) == pytest.approx(25.0)


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_request_flops_match_the_reference():
    from portbench.core import port

    counts = spec.piece("counts", "gennerf_living_spatial")
    ref = spec.piece("reference", "gennerf_living_spatial")
    with open(os.path.join(spec.PKG, "configs", "gennerf_living_spatial.json")) as f:
        cfg = tiny_gennerf(json.load(f))
    _, W = port.build(cfg["model"], "32-true", "cpu", 3)
    a = ref.Arith()
    T, H, Wd = cfg["num_frames"], cfg["frame_height"], cfg["frame_width"]
    images = torch.rand(T, 3, H, Wd)
    feat = ref.spatial_features(a, W, cfg, images)
    assert feat.shape[1] == counts.latent(cfg) == 512
    assert _counted(lambda: ref.spatial_features(a, W, cfg, images)) == T * counts.frame_flops(cfg)
    n = cfg["num_frames"] * cfg["model"]["encoder"]["pointnet"]["num_sparse_points"]
    pts = torch.rand(1, n, 3) - 0.5
    planes = ref.encode_planes(a, W, cfg, pts)
    xyz = ref.dense_points(cfg["voxel_dim_test"], cfg["voxel_size"], "cpu")
    vol = torch.rand(xyz.shape[0], counts.latent(cfg))
    per_point = _counted(lambda: ref.decode(a, W, cfg, planes, vol, xyz)) // xyz.shape[0]
    assert counts.request_flops(cfg) == (_counted(lambda: ref.encode_planes(a, W, cfg, pts))
                                         + xyz.shape[0] * per_point
                                         + T * counts.frame_flops(cfg))


def test_the_reference_imports_neither_the_program_nor_jax():
    probe = ("import sys, portbench.reference.gennerf_living_spatial\n"
             "print(' '.join(sorted({m.split('.', 1)[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=spec.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(out.stdout.split())
    assert "torch" in top
    assert not top & {"gennerf_tpu_torch", "gennerf_tpu", "jax", "jaxlib", "flax"}
