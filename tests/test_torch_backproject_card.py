"""The feature volume's backprojection kernel (csrc/backproject.cu) on the
card against the composition it replaces there (torch only: run on the
card's machine with
`python -m pytest --noconftest -q tests/test_torch_backproject_card.py`;
the `cuda` marker skips every test without a CUDA device, since a CUDA
kernel has no CPU mode).

Tolerance: none. The kernel adds the frames' values in the composition's
order, each add rounded once, and widens bf16 exactly, so the sum and the
count have the same bits: the spatial benchmark cell's shape, f32 and bf16
features, one and two batch items, one frame, rows with and without
16-byte vector loads, a grid outside every frustum, voxels rounding onto
pixel edges and behind the camera, zeros of both signs, infinities and
NaNs in the features, and VoxelNet's reconstruct through either route."""
import math
import os
import sys

import pytest
import torch

from gennerf_tpu_torch.ops import kernels
from gennerf_tpu_torch.ops import projection as proj
from gennerf_tpu_torch.utils import spans

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the backprojection kernel has no CPU mode")
    return torch.device("cuda")


def _ring(dev, B, T, image_hw, grid, voxel, seed):
    return chip_smoke.ring_projections(torch, dev, B, T, image_hw, grid, voxel, seed)


def _same_bits(a, b):
    assert a.dtype == b.dtype == F32 and a.shape == b.shape
    assert int((a.view(torch.int32) != b.view(torch.int32)).sum()) == 0


def _kernel_and_composition(feat, P, image_hw, grid, voxel, origin, channel_slices=1):
    """The no_grad fold through the kernel (one launch) against the
    composition, which runs on `channel_slices` channel slices (every step
    of it acts on each channel alone) to bound its memory."""
    before = kernels.BACKPROJECT.launches
    with torch.no_grad():
        volume, valid = proj.backproject_fold(feat, P, image_hw, grid, voxel, origin)
    torch.cuda.synchronize()
    assert kernels.BACKPROJECT.launches == before + 1
    C = feat.shape[1]
    step = -(-C // channel_slices)
    for c0 in range(0, C, step):
        want_volume, want_valid = proj.backproject_fold_plain(
            feat[:, c0:c0 + step], P, image_hw, grid, voxel, origin)
        _same_bits(volume[:, c0:c0 + step], want_volume)
        del want_volume
    _same_bits(valid, want_valid)
    return volume, valid


# case: (B, T, C, feature (Hf, Wf), grid, dtype); the images twice the features' size
CASES = {
    "f32_c512": (1, 4, 512, (60, 80), (40, 36, 28), F32),
    "bf16_c512": (1, 4, 512, (60, 80), (40, 36, 28), BF16),
    "f32_b2": (2, 3, 64, (60, 80), (40, 36, 28), F32),
    "bf16_b2": (2, 3, 64, (60, 80), (40, 36, 28), BF16),
    "f32_t1": (1, 1, 64, (60, 80), (40, 36, 28), F32),
    "bf16_t1": (1, 1, 512, (60, 80), (40, 36, 28), BF16),
    **{f"{name}_c{C}": (2, 3, C, (30, 40), (24, 20, 17), dtype)
       for C in (1, 33, 64) for name, dtype in (("f32", F32), ("bf16", BF16))},
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_is_bit_equal_to_the_composition(cuda, case):
    B, T, C, hw, grid, dtype = CASES[case]
    voxel = 0.05
    gen = torch.Generator(device=cuda).manual_seed(len(case))
    feat = torch.randn((B * T, C, *hw), generator=gen, device=cuda).to(dtype)
    image_hw = (2 * hw[0], 2 * hw[1])
    P = _ring(cuda, B, T, image_hw, grid, voxel, seed=len(case))
    origin = torch.tensor([0.03, -0.02, 0.01], device=cuda)
    _, valid = _kernel_and_composition(feat, P, image_hw, grid, voxel, origin)
    seen = valid > 0
    assert 0.05 < float(seen.float().mean()) < 1.0  # voxels seen and unseen


@pytest.mark.cuda
def test_spatial_cell_shape_is_bit_equal_to_the_composition(cuda):
    """The spatial benchmark cell's backprojection: 8 bf16 frames of 512
    channels at 480x640 (the images' own size) into 256x256x96 at 4 cm."""
    grid, voxel, hw = (256, 256, 96), 0.04, (480, 640)
    gen = torch.Generator(device=cuda).manual_seed(22)
    feat = torch.randn((8, 512, *hw), generator=gen, device=cuda).to(BF16)
    P = _ring(cuda, 1, 8, hw, grid, voxel, seed=22)
    _, valid = _kernel_and_composition(feat, P, hw, grid, voxel, torch.zeros(3, device=cuda),
                                       channel_slices=8)
    assert 0.0 < float(valid.mean()) < 8.0  # pairs seen and unseen


@pytest.mark.cuda
def test_grid_outside_every_frustum(cuda):
    grid, hw = (24, 20, 17), (30, 40)
    gen = torch.Generator(device=cuda).manual_seed(3)
    feat = torch.randn((2, 64, *hw), generator=gen, device=cuda).to(BF16)
    P = _ring(cuda, 1, 2, hw, grid, 0.05, seed=3)
    P[..., 2, 3] -= 100.0  # every voxel 100 m behind each camera
    volume, valid = _kernel_and_composition(feat, P, hw, grid, 0.05, torch.zeros(3, device=cuda))
    assert int(valid.count_nonzero()) == 0
    assert int(volume.view(torch.int32).count_nonzero()) == 0  # +0.0 everywhere


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_voxels_on_pixel_edges_and_behind_the_camera(cuda, dtype):
    """Frame 0 puts voxel (i, j, k) at pixel (i + 0.5, j + 0.5): every
    centre rounds half to even, and the grid runs past the image's right
    and bottom edges. Frame 1 puts the k = 2 plane at depth 0 and the
    planes below it behind the camera."""
    grid, hw = (20, 14, 5), (12, 16)
    P = torch.tensor([[[[1.0, 0.0, 0.0, 0.5], [0.0, 1.0, 0.0, 0.5], [0.0, 0.0, 0.0, 1.0]],
                       [[1.0, 0.0, 0.0, 0.5], [0.0, 1.0, 0.0, -0.5], [0.0, 0.0, 1.0, -2.0]]]],
                     device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    feat = torch.randn((2, 33, *hw), generator=gen, device=cuda).to(dtype)
    _, valid = _kernel_and_composition(feat, P, hw, grid, 1.0, torch.zeros(3, device=cuda))
    assert 0 < int(valid.count_nonzero()) < math.prod(grid)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [8, 33, 512])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_signed_zeros_infinities_and_nans(cuda, dtype, C):
    grid, hw = (24, 20, 17), (30, 40)
    gen = torch.Generator(device=cuda).manual_seed(C)
    feat = torch.randn((3, C, *hw), generator=gen, device=cuda)
    pick = torch.randint(0, 6, feat.shape, generator=gen, device=cuda)
    for v, value in enumerate((0.0, -0.0, math.inf, -math.inf, math.nan)):
        feat[pick == v] = value
    P = _ring(cuda, 1, 3, (60, 80), grid, 0.05, seed=C)
    _kernel_and_composition(feat.to(dtype), P, (60, 80), grid, 0.05, torch.zeros(3, device=cuda))


@pytest.mark.cuda
def test_unaligned_features_take_the_scalar_path(cuda):
    """Features starting 4 bytes off a 16-byte boundary (a channels_last
    view of an offset buffer, so no copy realigns them)."""
    grid, hw, C = (24, 20, 17), (30, 40), 64
    gen = torch.Generator(device=cuda).manual_seed(9)
    flat = torch.randn(3 * C * hw[0] * hw[1] + 1, generator=gen, device=cuda)
    feat = flat[1:].reshape(3, *hw, C).permute(0, 3, 1, 2)
    assert feat.is_contiguous(memory_format=torch.channels_last) and feat.data_ptr() % 16 == 4
    P = _ring(cuda, 1, 3, (60, 80), grid, 0.05, seed=9)
    _kernel_and_composition(feat, P, (60, 80), grid, 0.05, torch.zeros(3, device=cuda))


@pytest.mark.cuda
def test_dispatch_and_counters_on_the_card(cuda):
    grid, hw = (24, 20, 17), (30, 40)
    gen = torch.Generator(device=cuda).manual_seed(7)
    feat = torch.randn((2, 16, *hw), generator=gen, device=cuda)
    P = _ring(cuda, 1, 2, (60, 80), grid, 0.05, seed=7)
    origin = torch.zeros(3, device=cuda)
    V = math.prod(grid)
    spans.reset()
    before = kernels.BACKPROJECT.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            fast = proj.backproject_fold(feat, P, (60, 80), grid, 0.05, origin)
        graph = proj.backproject_fold(feat.requires_grad_(True), P, (60, 80), grid, 0.05, origin)
    assert kernels.BACKPROJECT.launches == before + 1
    assert graph[0].requires_grad and not fast[0].requires_grad
    c = spans.counters()
    spans.reset()
    assert c["backproject.pairs"] == 2 * 2 * V and c["backproject.kernel_pairs"] == 2 * V
    _same_bits(fast[0], graph[0].detach())
    _same_bits(fast[1], graph[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_voxelnet_reconstruct_through_either_route(cuda, dtype, monkeypatch):
    """VoxelNet's no_grad reconstruct (the benchmark's voxelnet_living
    configuration at its CPU-test sizes: 4 frames in chunks of 2) gives
    the same TSDF bits through the kernel as through the composition."""
    from gennerf_tpu_torch.data.synthetic import ring_frames
    from gennerf_tpu_torch.predict import reconstruct
    from gennerf_tpu_torch.train.tasks import model_config, task_for
    from portbench import run
    from portbench.core import spec
    from portbench.tests.tiny import tiny

    ctx = run.Ctx(spec.load_benchmark(), "voxelnet_living.train", 1, 0.1, False, cuda, t0=0.0)
    c = tiny(ctx.cfg)
    cfg = model_config(c["model"])
    torch.manual_seed(0)
    model = task_for(cfg).build(cfg, dtype).to(cuda).eval()
    T, chunk = c["num_frames"], cfg.encoder.spatial.frame_chunk
    P, image, depth = ring_frames(T, c["frame_height"], c["frame_width"], (1.6, 1.6, 0.8),
                                  [{"type": "sphere", "center": (1.5, 1.7, 0.5), "radius": 0.5}])
    before = kernels.BACKPROJECT.launches
    fast = reconstruct(model, P, image, depth)
    torch.cuda.synchronize()
    assert kernels.BACKPROJECT.launches == before + math.ceil(T / chunk)
    monkeypatch.setattr(proj, "backproject_kernel_takes", lambda feat: False)
    plain = reconstruct(model, P, image, depth)
    assert kernels.BACKPROJECT.launches == before + math.ceil(T / chunk)
    assert bool(torch.isfinite(fast).all())
    _same_bits(fast, plain)

