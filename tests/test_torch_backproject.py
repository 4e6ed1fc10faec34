"""The feature volume's backprojection (ops/projection.backproject_fold,
csrc/backproject.cu) on the CPU: the dispatch rule between the kernel and
the frame-by-frame composition, decided from the features' metadata before
any work; the composition-only runs launching nothing; the kernel wrapper's
checks, which raise before a launch; the counters in a traced
`predict.reconstruct` of a tiny combined-encoder GenNerf and the
benchmark's reader of them. The composition is held against the JAX
package's backproject_fold in tests/test_torch_spatial.py; the kernel
itself runs on the card only (tests/test_torch_backproject_card.py)."""
import math
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gennerf_tpu_torch.ops import kernels
from gennerf_tpu_torch.ops import projection as proj
from gennerf_tpu_torch.utils import spans

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

F32, BF16 = torch.float32, torch.bfloat16
VOXEL_DIM, VOXEL = (10, 9, 7), 0.1


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
    monkeypatch.setattr(proj, "backproject_fold_cuda", refuse)
    return kernels.BACKPROJECT.launches


def _like(device="cuda", dtype=F32, requires_grad=False):
    """A stand-in carrying only the metadata the rule reads."""
    return SimpleNamespace(device=torch.device(device), dtype=dtype, requires_grad=requires_grad)


# case: (features, grad mode on, the kernel takes it)
RULE = {
    "cuda_f32_no_grad": (_like(), False, True),
    "cuda_bf16_no_grad": (_like(dtype=BF16), False, True),
    "no_grad_despite_requires_grad": (_like(requires_grad=True), False, True),
    "grad_on_none_requires_grad": (_like(dtype=BF16), True, True),
    "grad_on_feature_requires_grad": (_like(requires_grad=True), True, False),
    "cpu": (_like("cpu"), False, False),
    "cpu_bf16": (_like("cpu", BF16), False, False),
    "float64": (_like(dtype=torch.float64), False, False),
    "float16": (_like(dtype=torch.float16), False, False),
}


@pytest.mark.parametrize("case", sorted(RULE))
def test_dispatch_rule(case):
    feat, grad, takes = RULE[case]
    with torch.set_grad_enabled(grad):
        assert proj.backproject_kernel_takes(feat) is takes


def _frames(B=2, T=3, C=5, hw=(12, 16), image_hw=(24, 32), seed=0):
    """(B*T, C, Hf, Wf) random features and (B, T, 3, 4) projections of
    cameras around the grid, some voxels outside every frustum."""
    g = torch.Generator().manual_seed(seed)
    feat = torch.randn((B * T, C, *hw), generator=g)
    H, W = image_hw
    K = torch.tensor([[0.9 * W, 0.0, W / 2], [0.0, 0.9 * W, H / 2], [0.0, 0.0, 1.0]])
    rows = []
    for b in range(B):
        for t in range(T):
            a = 0.3 * t - 0.2 * b
            R = torch.tensor([[math.cos(a), 0.0, -math.sin(a)], [0.0, 1.0, 0.0],
                              [math.sin(a), 0.0, math.cos(a)]])
            tvec = torch.tensor([-0.5 + 0.1 * t, -0.4, 0.4 + 0.1 * b])
            rows.append(K @ torch.cat([R, tvec[:, None]], 1))
    return feat, torch.stack(rows).reshape(B, T, 3, 4), image_hw


def _same_bits(a, b):
    assert a.dtype == b.dtype == F32 and a.shape == b.shape
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("case", ["cpu_f32", "cpu_bf16", "float64", "graph"])
def test_off_the_kernel_the_composition_runs_and_nothing_launches(case, no_launch):
    feat, P, hw = _frames()
    origin = torch.tensor([0.05, -0.02, 0.0])
    if case == "cpu_bf16":
        feat = feat.to(BF16)
    elif case == "float64":
        feat = feat.double()
    elif case == "graph":
        feat.requires_grad_(True)
    with profile(activities=[ProfilerActivity.CPU]):
        volume, valid = proj.backproject_fold(feat, P, hw, VOXEL_DIM, VOXEL, origin)
    want_volume, want_valid = proj.backproject_fold_plain(feat, P, hw, VOXEL_DIM, VOXEL, origin)
    _same_bits(volume, want_volume)
    _same_bits(valid, want_valid)
    assert volume.requires_grad is (case == "graph")
    V = math.prod(VOXEL_DIM)
    c = spans.counters()
    assert c == {"backproject.pairs": 2 * 3 * V, "backproject.kernel_pairs": 0,
                 "backproject.observed": float(valid.sum())}
    assert 0 < c["backproject.observed"] < 2 * 3 * V
    assert kernels.BACKPROJECT.launches == no_launch


def test_fold_pixels_are_the_compositions_pixels():
    """The kernel's indices pick, frame by frame, the features the
    composition gathers: summed in f32 in frame order they give its bits."""
    feat, P, hw = _frames(seed=3)
    feat[0, 1, 2, 3] = float("nan")
    feat[4, 0, 5, 6] = -0.0
    origin = torch.zeros(3)
    pixel = proj.fold_pixels(P, hw, feat.shape[2:], VOXEL_DIM, VOXEL, origin)
    B, T, V = pixel.shape
    assert pixel.dtype == torch.int32 and (B, T, V) == (2, 3, math.prod(VOXEL_DIM))
    rows = feat.permute(0, 2, 3, 1).reshape(B * T, -1, feat.shape[1])
    volume, valid = [], []
    for b in range(B):
        s = n = 0
        for t in range(T):
            p = pixel[b, t].long()
            seen = p >= 0
            x = torch.where(seen[:, None], rows[b * T + t, p.clamp(min=0)], torch.zeros(()))
            s, n = (x, seen.float()) if t == 0 else (s + x, n + seen.float())
        volume.append(s.T)
        valid.append(n)
    want_volume, want_valid = proj.backproject_fold_plain(feat, P, hw, VOXEL_DIM, VOXEL, origin)
    _same_bits(torch.stack(volume).reshape(want_volume.shape), want_volume)
    _same_bits(torch.stack(valid).reshape(want_valid.shape), want_valid)


def _bad(case):
    feat, P, _ = _frames(B=1, T=2)
    pixel = torch.full((1, 2, math.prod(VOXEL_DIM)), -1, dtype=torch.int32)
    voxel_dim = VOXEL_DIM
    if case == "features_rank_3":
        feat = feat[0]
    elif case == "empty_channel_axis":
        feat = feat[:, :0]
    elif case == "pixel_range_beyond_int32":
        feat = torch.zeros(()).expand(2, 5, 50000, 50000)
    elif case == "features_float64":
        feat = feat.double()
    elif case == "features_float16":
        feat = feat.half()
    elif case == "pixel_frames_mismatch":
        pixel = pixel[:, :1]
    elif case == "pixel_voxels_mismatch":
        pixel = pixel[..., 1:]
    elif case == "pixel_rank_2":
        pixel = pixel[0]
    elif case == "voxels_beyond_int32":
        voxel_dim = (2048, 1024, 1024)
        pixel = torch.zeros((), dtype=torch.int32).expand(1, 2, 2 ** 31)
    elif case == "pixel_int64":
        pixel = pixel.long()
    elif case == "pixel_not_contiguous":
        pixel = torch.full((1, math.prod(VOXEL_DIM), 2), -1, dtype=torch.int32).transpose(1, 2)
    return feat, pixel, voxel_dim


BAD = {"features_rank_3": r"\(B\*T, C, Hf, Wf\)", "empty_channel_axis": r"\(B\*T, C, Hf, Wf\)",
       "pixel_range_beyond_int32": "fit int32", "features_float64": "float32 or bfloat16",
       "features_float16": "float32 or bfloat16", "pixel_frames_mismatch": "B\\*T = 2",
       "pixel_voxels_mismatch": r"\(B, T, 630\)", "pixel_rank_2": r"\(B, T, 630\)",
       "voxels_beyond_int32": "do not fit int32", "pixel_int64": "expected int32",
       "pixel_not_contiguous": "contiguous", "cpu_tensors": "CUDA tensor"}


@pytest.mark.parametrize("case", sorted(BAD))
def test_kernel_wrapper_raises_before_launching(case, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(kernels, "load_library", refuse)
    before = kernels.BACKPROJECT.launches
    feat, pixel, voxel_dim = _bad(case)
    with pytest.raises(ValueError, match=BAD[case]):
        proj.backproject_fold_cuda(feat, pixel, voxel_dim)
    assert kernels.BACKPROJECT.launches == before


def _tiny_spatial_model():
    """The spatial cell's configuration at the benchmark's CPU-test sizes."""
    from portbench import run
    from portbench.core import spec
    from portbench.tests.tiny import tiny
    from gennerf_tpu_torch.train.tasks import model_config, task_for

    ctx = run.Ctx(spec.load_benchmark(), "gennerf_living_spatial.recon", 1, 0.1, False,
                  torch.device("cpu"), t0=0.0)
    cfg = model_config(tiny(ctx.cfg)["model"])
    torch.manual_seed(0)
    return task_for(cfg).build(cfg, F32).eval()


def test_traced_reconstruct_counts_every_pair_off_the_kernel():
    from gennerf_tpu_torch.data.synthetic import ring_frames
    from gennerf_tpu_torch.predict import reconstruct

    model = _tiny_spatial_model()
    T, H, W = 2, 24, 32
    P, image, depth = ring_frames(T, H, W, (1.6, 1.6, 0.4),
                                  [{"type": "sphere", "center": (1.5, 1.7, 0.4), "radius": 0.4}])
    dims = tuple(int(d) for d in model.cfg.voxel_dim_test)
    with profile(activities=[ProfilerActivity.CPU]):
        tsdf = reconstruct(model, P, image, depth, dims, torch.Generator().manual_seed(1))
    assert tsdf.shape == dims and bool(torch.isfinite(tsdf).all())
    c = spans.counters()
    assert c["backproject.pairs"] == T * math.prod(dims)
    assert c["backproject.kernel_pairs"] == 0
    assert 0 < c["backproject.observed"] <= c["backproject.pairs"]


def test_backproject_kernel_share_reader():
    from portbench.core import spec

    reader = spec.piece("metrics", "backproject_kernel_share.infer")
    assert reader.read(None) is None
    with profile(activities=[ProfilerActivity.CPU]):
        spans.count("backproject.pairs", 400)
        spans.count("backproject.kernel_pairs", 400)
        spans.count("backproject.pairs", 400)
        spans.count("backproject.kernel_pairs", 0)
    assert reader.read(None) == pytest.approx(50.0)
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):  # a program without the kernel
        spans.count("backproject.pairs", 400)
    assert reader.read(None) is None
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        spans.count("backproject.pairs", 0)
        spans.count("backproject.kernel_pairs", 0)
    assert reader.read(None) is None


def test_build_rows_and_spill_gate():
    """The ptxas parse and build gate chip_smoke.py runs name the kernel's
    instances by element type and vector width; a spill in any fails."""
    from gennerf_tpu_torch.tools import measure

    entries = {"f32x4": "IfLi4EEEvPKT_PKiPfS5_ixiii",
               "bf16x8": "I13__nv_bfloat16Li8EEEvPKT_PKiPfS6_ixiii"}
    log = "".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118backproject_kernel{e}' "
        f"for 'sm_90a'\nptxas info    : Used 64 registers\n"
        f"    0 bytes stack frame, {4 * i} bytes spill stores, {4 * i} bytes spill loads\n"
        for i, e in enumerate(entries.values()))
    rows = measure.ptxas_rows(log)
    assert set(rows) == {("backproject", "f32x4"), ("backproject", "bf16x8")}
    assert rows[("backproject", "f32x4")] == {"kernel": "backproject", "instance": "f32x4",
                                              "registers": 64, "spill_store_bytes": 0,
                                              "spill_load_bytes": 0}
    report = {"cuobjdump": "missing", "kernels": list(rows.values())}
    with pytest.raises(RuntimeError, match="backproject kernel spills"):
        measure.check_build(report)
    rows[("backproject", "bf16x8")].update(spill_store_bytes=0, spill_load_bytes=0)
    measure.check_build(report)
