"""The feature volume's trilinear sample (ops/interpolation.py,
csrc/volume_sample.cu) on the CPU: the dispatch rule between the kernel and
the composition of gathers and lerps, decided from the inputs' metadata
before any work; the kernel wrapper's checks, which raise before a launch;
the counters in a traced `decode_dense` of a small volume scene and the
benchmark's reader of them. The composition is held against the JAX
package's trilinear in tests/test_torch_train.py; the kernel itself runs on
the card only (tests/test_torch_volume_sample_card.py)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gennerf_tpu_torch.models.gen_nerf import SceneRepr
from gennerf_tpu_torch.ops import interpolation as interp
from gennerf_tpu_torch.ops import kernels
from gennerf_tpu_torch.utils import spans

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture(autouse=True)
def _fresh_counts():
    spans.reset()
    yield
    spans.reset()


@pytest.fixture
def no_launch(monkeypatch):
    """Any build or launch of a kernel fails the test."""
    def refuse(*_a, **_k):
        raise AssertionError("a kernel was built or launched")

    monkeypatch.setattr(kernels, "load_library", refuse)
    monkeypatch.setattr(interp, "trilinear_interpolation_cuda", refuse)
    return kernels.VOLUME_SAMPLE.launches


def _like(device="cuda", dtype=F32, requires_grad=False):
    """A stand-in carrying only the metadata the rule reads."""
    return SimpleNamespace(device=torch.device(device), dtype=dtype, requires_grad=requires_grad)


# case: (volume, points, origin, mode, grad mode on, the kernel takes it)
RULE = {
    "cuda_f32": (_like(), _like(), None, "bilinear", True, True),
    "cuda_bf16_volume": (_like(dtype=BF16), _like(), None, "bilinear", True, True),
    "no_grad_despite_requires_grad": (_like(requires_grad=True), _like(requires_grad=True), None,
                                      "bilinear", False, True),
    "cpu": (_like("cpu"), _like("cpu"), None, "bilinear", True, False),
    "volume_on_cpu": (_like("cpu"), _like(), None, "bilinear", True, False),
    "points_on_cpu": (_like(), _like("cpu"), None, "bilinear", True, False),
    "float64": (_like(dtype=torch.float64), _like(dtype=torch.float64), None, "bilinear", True,
                False),
    "float16_volume": (_like(dtype=torch.float16), _like(), None, "bilinear", True, False),
    "bf16_points": (_like(), _like(dtype=BF16), None, "bilinear", True, False),
    "nearest": (_like(), _like(), None, "nearest", True, False),
    "graph_through_volume": (_like(requires_grad=True), _like(), None, "bilinear", True, False),
    "graph_through_points": (_like(), _like(requires_grad=True), None, "bilinear", True, False),
    "graph_through_origin": (_like(), _like(), torch.zeros(3, requires_grad=True), "bilinear", True,
                             False),
}


@pytest.mark.parametrize("case", sorted(RULE))
def test_dispatch_rule(case):
    vol, xyz, origin, mode, grad, takes = RULE[case]
    with torch.set_grad_enabled(grad):
        assert interp.volume_kernel_takes(vol, xyz, origin, mode) is takes


def _inputs(B=2, dims=(6, 5, 4), C=3, N=50, dtype=F32, seed=0):
    rng = np.random.default_rng(seed)
    vol = torch.from_numpy(rng.uniform(-1, 1, (B, *dims, C)).astype(np.float32)).to(dtype)
    xyz = torch.from_numpy(rng.uniform(-0.2, 0.8, (B, N, 3)).astype(np.float32))
    origin = torch.tensor([0.02, -0.01, 0.0])
    return vol, xyz, origin


@pytest.mark.parametrize("case", ["cpu_f32", "cpu_bf16_volume", "graph", "float64", "nearest"])
def test_off_the_kernel_the_composition_runs_and_nothing_launches(case, no_launch):
    vol, xyz, origin = _inputs(dtype=BF16 if case == "cpu_bf16_volume" else F32)
    mode = "nearest" if case == "nearest" else "bilinear"
    if case == "float64":
        vol, xyz, origin = vol.double(), xyz.double(), origin.double()
    if case == "graph":
        vol.requires_grad_(True)
    with profile(activities=[ProfilerActivity.CPU]):
        out = interp.trilinear_interpolation(vol, xyz, origin, 0.1, mode)
    want = interp.trilinear_interpolation_plain(vol, xyz, origin, 0.1, mode)
    assert out.dtype == want.dtype and torch.equal(out, want)
    assert out.requires_grad is (case == "graph")
    assert spans.counters() == {"trilinear.points": 100, "trilinear.kernel_points": 0}
    assert kernels.VOLUME_SAMPLE.launches == no_launch


def _bad(case):
    vol, xyz, origin = _inputs()
    if case == "volume_not_contiguous":
        vol = vol.permute(0, 2, 1, 3, 4)
    elif case == "points_not_contiguous":
        xyz = xyz.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "volume_rank_4":
        vol = vol[0]
    elif case == "points_rank_2":
        xyz = xyz[0]
    elif case == "points_not_xyz":
        xyz = xyz[..., :2].contiguous()
    elif case == "batch_mismatch":
        xyz = xyz[:1]
    elif case == "volume_float64":
        vol = vol.double()
    elif case == "volume_float16":
        vol = vol.half()
    elif case == "points_bf16":
        xyz = xyz.to(BF16)
    elif case == "empty_axis":
        vol = vol[:, :0]
    elif case == "origin_of_two":
        origin = origin[:2]
    return vol, xyz, origin


BAD = {"volume_not_contiguous": "contiguous", "points_not_contiguous": "contiguous",
       "volume_rank_4": r"\(B, nx, ny, nz, C\)", "points_rank_2": r"\(B, N, 3\)",
       "points_not_xyz": r"\(B, N, 3\)", "batch_mismatch": r"\(B, N, 3\)",
       "volume_float64": "float32 or bfloat16", "volume_float16": "float32 or bfloat16",
       "points_bf16": "expected float32", "empty_axis": r"nx, ny, nz, C in",
       "origin_of_two": "3 values", "cpu_tensors": "CUDA tensor"}


@pytest.mark.parametrize("case", sorted(BAD))
def test_kernel_wrapper_raises_before_launching(case, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(kernels, "load_library", refuse)
    before = kernels.VOLUME_SAMPLE.launches
    vol, xyz, origin = _bad(case)
    with pytest.raises(ValueError, match=BAD[case]):
        interp.trilinear_interpolation_cuda(vol, xyz, origin, 0.1)
    assert kernels.VOLUME_SAMPLE.launches == before


def _volume_scene():
    """A tiny combined-encoder GenNerf (the spatial cell's configuration at
    the benchmark's CPU-test sizes) and a random scene: its planes, a
    512-channel summed volume and its counts (some voxels unseen)."""
    from portbench import run
    from portbench.core import spec
    from portbench.tests.tiny import tiny
    from gennerf_tpu_torch.train.tasks import model_config, task_for

    ctx = run.Ctx(spec.load_benchmark(), "gennerf_living_spatial.recon", 1, 0.1, False,
                  torch.device("cpu"), t0=0.0)
    cfg = model_config(tiny(ctx.cfg)["model"])
    torch.manual_seed(0)
    model = task_for(cfg).build(cfg, F32).eval()
    p = cfg.encoder.pointnet
    g = torch.Generator().manual_seed(1)
    planes = {k: torch.randn(1, p.c_dim, p.plane_resolution, p.plane_resolution, generator=g)
              for k in p.plane_type}
    C = model.mlp.lin_in.weight.shape[1] - p.c_dim
    dims = tuple(int(d) for d in cfg.voxel_dim_test)
    volume = torch.randn(1, C, *dims, generator=g)
    valid = torch.randint(0, 3, (1, 1, *dims), generator=g).float()
    return model, SceneRepr(planes, volume, valid), dims


def test_traced_decode_dense_counts_every_sampled_point():
    from gennerf_tpu_torch.train.predict import decode_dense, dense_grid_points

    model, repr_, dims = _volume_scene()
    pts = dense_grid_points(dims, model.cfg.voxel_size, torch.zeros(3))
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        tsdf = decode_dense(model, repr_, pts, torch.zeros(3), chunk_size=300)
    n = pts.shape[0]
    assert tsdf.shape == (n,) and bool(torch.isfinite(tsdf).all())
    c = spans.counters()
    assert c["trilinear.points"] == c["decode.dense_points"] == n
    assert c["trilinear.kernel_points"] == 0


def test_trilinear_kernel_share_reader():
    from portbench.core import spec

    reader = spec.piece("metrics", "trilinear_kernel_share.infer")
    assert reader.read(None) is None
    with profile(activities=[ProfilerActivity.CPU]):
        spans.count("trilinear.points", 400)
        spans.count("trilinear.kernel_points", 300)
        spans.count("trilinear.points", 200)
        spans.count("trilinear.kernel_points", 0)
    assert reader.read(None) == pytest.approx(50.0)
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        spans.count("trilinear.points", 400)
    assert reader.read(None) is None


def test_build_rows_and_spill_gate():
    """The ptxas parse and build gate chip_smoke.py runs name the kernel's
    instances by element type and vector width; a spill in any fails."""
    from gennerf_tpu_torch.tools import measure

    entries = {"f32x4": "IfLi4EEEvPKT_PKfS5_Pfxxiiiifffi",
               "bf16x8": "I13__nv_bfloat16Li8EEEvPKT_PKfS6_Pfxxiiiifffi"}
    log = "".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120volume_sample_kernel{e}' "
        f"for 'sm_90a'\nptxas info    : Used 48 registers\n"
        f"    0 bytes stack frame, {4 * i} bytes spill stores, {4 * i} bytes spill loads\n"
        for i, e in enumerate(entries.values()))
    rows = measure.ptxas_rows(log)
    assert set(rows) == {("volume_sample", "f32x4"), ("volume_sample", "bf16x8")}
    assert rows[("volume_sample", "f32x4")] == {"kernel": "volume_sample", "instance": "f32x4",
                                                "registers": 48, "spill_store_bytes": 0,
                                                "spill_load_bytes": 0}
    report = {"cuobjdump": "missing", "kernels": list(rows.values())}
    with pytest.raises(RuntimeError, match="volume_sample kernel spills"):
        measure.check_build(report)
    rows[("volume_sample", "bf16x8")].update(spill_store_bytes=0, spill_load_bytes=0)
    measure.check_build(report)
