"""The feature volume's trilinear sample kernel (csrc/volume_sample.cu) on
the card against the composition it replaces there (torch only: run on the
card's machine with
`python -m pytest --noconftest -q tests/test_torch_volume_sample_card.py`;
the `cuda` marker skips every test without a CUDA device, since a CUDA
kernel has no CPU mode).

Tolerance: none. The kernel repeats the composition's f32 operations in
their order, each rounded once, so every output element has the same bits:
f32 and bf16 volumes, row widths with and without 16-byte vector loads, an
unaligned volume, points inside and outside the volume and on grid points,
zeros of both signs, infinities and NaNs in the volume."""
import math

import pytest
import torch

from gennerf_tpu_torch.ops import interpolation as interp
from gennerf_tpu_torch.ops import kernels
from gennerf_tpu_torch.train.predict import dense_grid_points
from gennerf_tpu_torch.utils import spans

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

VOXEL = 0.04


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the volume sample kernel has no CPU mode")
    return torch.device("cuda")


def _points(gen, dev, B, grid, n, offset):
    """n points a batch item: inside the volume, up to a fifth of its extent
    outside, and on grid points."""
    ext = torch.tensor([g * VOXEL for g in grid], device=dev)
    k = n // 3
    inside = torch.rand((B, k, 3), generator=gen, device=dev) * ext
    outside = (torch.rand((B, k, 3), generator=gen, device=dev) * 1.4 - 0.2) * ext
    grid_pts = dense_grid_points(grid, VOXEL, torch.zeros(3, device=dev), dev)
    hits = grid_pts[torch.randint(0, grid_pts.shape[0], (B, n - 2 * k), generator=gen, device=dev)]
    return (torch.cat([inside, outside, hits], dim=1) + offset).contiguous()


def _same_bits(a, b):
    assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
    assert int((a.view(torch.int32) != b.view(torch.int32)).sum()) == 0


# case: (B, grid, C, dtype)
CASES = {
    "f32_c512": (1, (24, 20, 16), 512, torch.float32),
    "bf16_c512": (1, (24, 20, 16), 512, torch.bfloat16),
    "f32_c1": (2, (17, 9, 11), 1, torch.float32),
    "bf16_c1": (2, (17, 9, 11), 1, torch.bfloat16),
    "f32_c33": (2, (13, 10, 7), 33, torch.float32),
    "bf16_c33": (2, (13, 10, 7), 33, torch.bfloat16),
    "f32_c64": (2, (13, 10, 7), 64, torch.float32),
    "bf16_c64": (2, (13, 10, 7), 64, torch.bfloat16),
    "bf16_c4": (1, (13, 10, 7), 4, torch.bfloat16),
    "f32_unit_axis": (1, (1, 10, 7), 8, torch.float32),
    **{f"{name}_c{C}_b2_40x36x28": (2, (40, 36, 28), C, dtype)
       for C in (1, 33, 64) for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))},
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_is_bit_equal_to_the_composition(cuda, case):
    B, grid, C, dtype = CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(len(case))
    vol = torch.randn((B, *grid, C), generator=gen, device=cuda).to(dtype)
    origin = torch.tensor([0.3, -0.2, 0.1], device=cuda)
    xyz = _points(gen, cuda, B, grid, 3001, origin)
    before = kernels.VOLUME_SAMPLE.launches
    got = interp.trilinear_interpolation_cuda(vol, xyz, origin, VOXEL)
    want = interp.trilinear_interpolation_plain(vol, xyz, origin, VOXEL)
    torch.cuda.synchronize()
    assert kernels.VOLUME_SAMPLE.launches == before + 1
    _same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("points", ["grid", "random"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_spatial_cell_chunk_is_bit_equal_to_the_composition(cuda, dtype, points):
    """One decode chunk of the spatial benchmark cell: 262,144 points (its
    grid's 13th chunk of 24, or as many inside, outside and on its grid) of
    a 256x256x96 volume of 512 channels."""
    grid, C, n = (256, 256, 96), 512, 262144
    gen = torch.Generator(device=cuda).manual_seed(12)
    vol = torch.randn((1, *grid, C), generator=gen, device=cuda).to(dtype)
    origin = torch.zeros(3, device=cuda)
    if points == "grid":
        xyz = dense_grid_points(grid, VOXEL, origin, cuda)[12 * n:13 * n][None].contiguous()
    else:
        xyz = _points(gen, cuda, 1, grid, n, origin)
    _same_bits(interp.trilinear_interpolation_cuda(vol, xyz, origin, VOXEL),
               interp.trilinear_interpolation_plain(vol, xyz, origin, VOXEL))


@pytest.mark.cuda
@pytest.mark.parametrize("grid, C, offset", [((12, 9, 10), 16, 1), ((40, 36, 28), 64, 1),
                                             ((40, 36, 28), 8, 0)])
def test_unaligned_volume_and_special_values(cuda, grid, C, offset):
    """Offset 1: 4 bytes off a 16-byte boundary (scalar loads)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    flat = torch.randn(math.prod(grid) * C + 1, generator=gen, device=cuda)
    vol = flat[offset:offset + math.prod(grid) * C].reshape(1, *grid, C)
    pick = torch.randint(0, 6, vol.shape, generator=gen, device=cuda)
    for v, value in enumerate((0.0, -0.0, math.inf, -math.inf, math.nan)):
        vol[pick == v] = value
    xyz = _points(gen, cuda, 1, grid, 2000, torch.zeros(3, device=cuda))
    origin = torch.zeros(3, device=cuda)
    _same_bits(interp.trilinear_interpolation_cuda(vol, xyz, origin, VOXEL),
               interp.trilinear_interpolation_plain(vol, xyz, origin, VOXEL))


@pytest.mark.cuda
def test_empty_points_launch_nothing(cuda):
    vol = torch.randn((1, 4, 4, 4, 8), device=cuda)
    before = kernels.VOLUME_SAMPLE.launches
    out = interp.trilinear_interpolation_cuda(vol, torch.zeros((1, 0, 3), device=cuda),
                                              torch.zeros(3, device=cuda), VOXEL)
    assert out.shape == (1, 0, 8) and kernels.VOLUME_SAMPLE.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("grid, n", [((10, 8, 6), 900), ((40, 36, 28), 3000)])
def test_dispatch_on_the_card(cuda, grid, n):
    gen = torch.Generator(device=cuda).manual_seed(7)
    vol = torch.randn((1, *grid, 64), generator=gen, device=cuda)
    # a channels-first volume permuted to channels-last (the grid plane's)
    vol_cf = vol.permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1)
    xyz = _points(gen, cuda, 1, grid, n, torch.zeros(3, device=cuda))
    origin = torch.zeros(3, device=cuda)
    spans.reset()
    before = kernels.VOLUME_SAMPLE.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            fast = interp.trilinear_interpolation(vol_cf, xyz, origin, VOXEL)
        graph = interp.trilinear_interpolation(vol.requires_grad_(True), xyz, origin, VOXEL)
    assert kernels.VOLUME_SAMPLE.launches == before + 1
    assert graph.requires_grad
    assert spans.counters() == {"trilinear.points": 2 * n, "trilinear.kernel_points": n}
    spans.reset()
    _same_bits(fast, graph.detach())
