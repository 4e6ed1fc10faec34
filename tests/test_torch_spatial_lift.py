"""The spatial encoder's fused lift (ops/spatial_lift.py, csrc/spatial_lift.cu):
every map resized to the stem's size, concatenated and projected by the 1x1
`proj` conv, as one operation with a reassociated backward.

On the CPU: the backward (R^T g first, at each map's resolution, then the
matrix products) against autograd of the unfused code in float64 at ResNet-18
and ResNet-50 widths, num_layers 2-4, feature_scale 1 and 2 and odd map
sizes; the tap tables, the transposed resize, the weight packing and the
checks; the dispatch's static conditions and counters; the benchmark's
reader of the counters.

On the card (the `cuda` marker; skipped without a CUDA device, since a CUDA
kernel has no CPU mode), this file imports torch and the port only:

    python -m pytest --noconftest -q tests/test_torch_spatial_lift.py

the kernel's forward against the plain bf16 path, its gradients against the
unfused autograd judged against float64 (the lift in float64 on the same
bf16-rounded interpolation weights), two runs bit-equal, the launch
counts, and the dispatch on the card. Forward tolerance: both paths rebuild
bit-equal latent values and weights and sum their exact bf16 products in
f32, in another order (wgmma's against cuDNN's), then round to bf16, add
the bias in bf16 and round again. The orders move a sum by ~1e-6 of its
size, so an element may land one bf16 step away at each of the two
roundings and on very few elements: |kernel - plain| <= step(y) +
step(out), y the conv before the bias, on under 1% of the elements.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gennerf_tpu_torch.models.spatial_encoder import SpatialEncoder, spatial_latent_size
from gennerf_tpu_torch.ops import kernels
from gennerf_tpu_torch.ops import spatial_lift as sl
from gennerf_tpu_torch.utils import spans

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)
from _torch_referee import FACTOR, assert_nearer_float64

EXPANSION = {"resnet18": 1, "resnet50": 4}
F64 = torch.float64
BF16 = torch.bfloat16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the lift kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _fresh_counts():
    spans.reset()
    yield
    spans.reset()


def _half(n: int) -> int:
    """A 3x3 (or 7x7) stride-2 conv's or the max pool's output size."""
    return (n - 1) // 2 + 1


def map_shapes(backbone: str, num_layers: int, hw, feature_scale: float, N: int = 2):
    """The encoder's maps for (H, W) images: stem, then the stages."""
    h, w = (int(s * feature_scale) for s in hw)
    h, w = _half(h), _half(w)
    e = EXPANSION[backbone]
    shapes = [(N, 64, h, w)]
    h, w = _half(h), _half(w)  # the first pool
    for i in range(num_layers - 1):
        if i > 0:
            h, w = _half(h), _half(w)
        shapes.append((N, 64 * 2 ** i * e, h, w))
    return shapes


def _inputs(shapes, cout, dtype, device="cpu", seed=0):
    rng = np.random.default_rng(seed)
    maps = [torch.from_numpy(rng.standard_normal(s)).to(device, dtype) for s in shapes]
    K = sum(s[1] for s in shapes)
    weight = torch.from_numpy(rng.standard_normal((cout, K, 1, 1)) / np.sqrt(K)).to(device)
    bias = torch.from_numpy(rng.standard_normal(cout) * 0.1).to(device)
    g = torch.from_numpy(rng.standard_normal((shapes[0][0], cout, *shapes[0][2:])))
    return maps, weight, bias, g.to(device)


def _grads(fn, maps, weight, bias, g):
    maps = [m.detach().requires_grad_() for m in maps]
    weight, bias = weight.detach().requires_grad_(), bias.detach().requires_grad_()
    out = fn(maps, weight, bias)
    return out.detach(), torch.autograd.grad(out, [weight, bias, *maps], g.to(out.dtype))


# -- on the CPU ----------------------------------------------------------------------

def test_map_shapes_are_the_encoders():
    enc = SpatialEncoder("resnet18", 4, feature_scale=2.0)
    with torch.no_grad():
        feats = enc.resnet(torch.zeros(2, 3, 46, 62))
    assert [tuple(f.shape) for f in feats] == map_shapes("resnet18", 4, (23, 31), 2.0)


@pytest.mark.parametrize("feature_scale", [1.0, 2.0])
@pytest.mark.parametrize("num_layers", [2, 3, 4])
@pytest.mark.parametrize("backbone", ["resnet18", "resnet50"])
def test_backward_matches_autograd_of_the_unfused_path_float64(backbone, num_layers,
                                                               feature_scale):
    shapes = map_shapes(backbone, num_layers, (23, 31), feature_scale)
    assert sum(s[1] for s in shapes) == spatial_latent_size(backbone, num_layers)
    cout = 24 if backbone == "resnet18" else 40
    maps, weight, bias, g = _inputs(shapes, cout, F64)
    out, fused = _grads(sl.spatial_lift, maps, weight, bias, g)
    ref_out, unfused = _grads(sl.spatial_lift_plain, maps, weight, bias, g)
    assert torch.equal(out, ref_out)
    for name, a, b in zip(["weight", "bias"] + [f"map{i}" for i in range(len(maps))],
                          fused, unfused):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max()), name


def test_float64_referee_is_the_lift_on_rounded_taps():
    """At float64 taps the referee is the plain lift. At bf16 taps it holds
    the fused bf16 lift's float32 weight gradient to float32 noise, where the
    float64-tap lift is as far as the taps' rounding moves it."""
    shapes = map_shapes("resnet18", 3, (23, 31), 2.0)
    maps, weight, bias, g = _inputs(shapes, 32, F64)
    assert torch.allclose(sl.spatial_lift_float64(maps, weight, bias, F64),
                          sl.spatial_lift_plain(maps, weight, bias), rtol=1e-13, atol=1e-13)
    maps, g = [m.to(BF16) for m in maps], g.to(BF16).double()
    wide = [m.double() for m in maps]
    _, fused = _grads(sl.spatial_lift, maps, weight.float(), bias.float(), g)
    _, ref = _grads(lambda m, w, b: sl.spatial_lift_float64(m, w, b, BF16), wide, weight, bias, g)
    _, taps64 = _grads(sl.spatial_lift_plain, wide, weight, bias, g)
    scale = float(ref[0].abs().max())
    assert float((fused[0].double() - ref[0]).abs().max()) < 1e-5 * scale
    assert float((taps64[0] - ref[0]).abs().max()) > 1e-4 * scale


@pytest.mark.parametrize("size, out_size", [(5, 37), (30, 60), (60, 480), (7, 7), (9, 4), (1, 6)])
def test_lerp_table_holds_the_taps_and_their_footprints(size, out_size):
    i0, i1, w = sl._lerp_taps(size, out_size, BF16, "cpu")
    t = sl.lerp_table(size, out_size, BF16, "cpu")
    assert t.dtype == torch.int32 and t.shape == (4 * out_size + 2 * size,)
    o = out_size
    assert torch.equal(t[:o].long(), i0) and torch.equal(t[o:2 * o].long(), i1)
    assert torch.equal(t[2 * o:3 * o].view(torch.float32), w.float())
    assert torch.equal(t[3 * o:4 * o].view(torch.float32), (1 - w).float())
    lo, hi = t[4 * o:4 * o + size], t[4 * o + size:]
    for i in range(size):
        touched = [j for j in range(out_size) if i0[j] == i or i1[j] == i]
        if touched:
            assert (int(lo[i]), int(hi[i])) == (min(touched), max(touched) + 1)
        else:
            assert int(lo[i]) == int(hi[i]) == 0
    assert sl.lerp_table(size, out_size, BF16, "cpu") is t  # cached


@pytest.mark.parametrize("hw, out_hw", [((3, 4), (23, 31)), ((12, 16), (23, 31)),
                                        ((23, 31), (23, 31)), ((8, 5), (8, 11))])
def test_resize_transpose_is_the_adjoint_of_the_resize(hw, out_hw):
    rng = np.random.default_rng(1)
    f = torch.from_numpy(rng.standard_normal((2, 3, *hw)))
    g = torch.from_numpy(rng.standard_normal((2, 3, *out_hw)))
    lhs = float((sl.resize_bilinear_align_corners(f, out_hw) * g).sum())
    rhs = float((f * sl.resize_transpose_plain(g, hw, F64)).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs) + 1e-12


@pytest.mark.parametrize("cout, rows", [(8, 32), (32, 32), (40, 64), (256, 256)])
def test_pack_lift_weight_layout(cout, rows):
    K = 96
    w = torch.randn(cout, K, 1, 1)
    packed = sl.pack_lift_weight(w, rows).reshape(-1)
    assert packed.dtype == BF16 and packed.numel() == K * rows
    o, k = torch.meshgrid(torch.arange(rows), torch.arange(K), indexing="ij")
    at = packed[((k // 8) * rows + o) * 8 + k % 8]
    assert torch.equal(at[:cout], w.reshape(cout, K).to(BF16))
    assert not at[cout:].any()


@pytest.mark.parametrize("case", ["six_maps", "channels_24", "cout_12", "cout_264",
                                  "weight_k", "no_bias", "batch"])
def test_check_lift_raises_up_front(case):
    shapes = map_shapes("resnet18", 3, (23, 31), 2.0)
    cout = {"cout_12": 12, "cout_264": 264}.get(case, 32)
    if case == "six_maps":
        shapes = shapes * 2
    if case == "channels_24":
        shapes[1] = (2, 24, *shapes[1][2:])
    if case == "batch":
        shapes[2] = (3, *shapes[2][1:])
    maps = [torch.zeros(s) for s in shapes]
    K = sum(s[1] for s in shapes) + (16 if case == "weight_k" else 0)
    weight, bias = torch.zeros(cout, K, 1, 1), None if case == "no_bias" else torch.zeros(cout)
    with pytest.raises(ValueError):
        sl.spatial_lift(maps, weight, bias)


@pytest.mark.parametrize("case, raises", [
    ("batch_70000", False),        # beyond a grid's y limit of 65535: the grids fold it into x
    ("forward_grid", True),        # N * 64-pixel tiles of the stem beyond int32
    ("gather_grid", True),         # N * cout * 256-texel tiles of a map beyond int32
    ("plane", True),               # a map's plane beyond int32 pixels
])
def test_check_lift_bounds_the_grids(case, raises):
    N, stem, small = {"batch_70000": (70000, (6, 5), (3, 3)),
                      "forward_grid": (2 ** 16, (1 << 12, 1 << 12), (3, 3)),
                      "gather_grid": (2 ** 16, (16, 16), (256, 1024)),
                      "plane": (1, (1, 1), (1 << 16, 1 << 15))}[case]
    maps = [torch.empty(N, 16, *stem, device="meta"), torch.empty(N, 16, *small, device="meta")]
    weight, bias = torch.empty(256, 32, 1, 1), torch.empty(256)
    if raises:
        with pytest.raises(ValueError, match="grids"):
            sl.check_lift(maps, weight, bias)
    else:
        sl.check_lift(maps, weight, bias)


def test_plain_lift_is_the_unfused_encoder_code_bf16():
    enc = SpatialEncoder("resnet18", 3, feature_scale=2.0, out_channels=32, dtype=BF16)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 3, 46, 62))).float()
    with torch.no_grad():
        feats = enc.resnet(x)
        latent = torch.cat([sl.resize_bilinear_align_corners(f, feats[0].shape[-2:])
                            for f in feats], 1)
        want = enc.proj(latent)
        got = sl.spatial_lift_plain(feats, enc.proj.weight, enc.proj.bias)
    assert got.dtype == BF16 and torch.equal(got, want)


@pytest.mark.parametrize("case, fused", [("bf16_proj", True), ("f32_proj", False),
                                         ("bf16_no_proj", False), ("bf16_nearest", False)])
def test_fused_lift_static_conditions(case, fused):
    enc = SpatialEncoder("resnet18", 1 if case == "bf16_nearest" else 3,
                         out_channels=None if case == "bf16_no_proj" else 32,
                         dtype=torch.float32 if case == "f32_proj" else BF16,
                         upsample_interp="nearest" if case == "bf16_nearest" else "bilinear")
    assert enc.fused_lift is fused


def test_cpu_runs_the_unfused_code_and_counts_its_pixels():
    enc = SpatialEncoder("resnet18", 3, feature_scale=2.0, out_channels=32, dtype=BF16)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 3, 23, 31))).float()
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        out = enc(x)
    assert tuple(out.shape) == (2, 32, 23, 31)
    assert spans.counters() == {"lift.pixels": 2 * 23 * 31}


def test_lift_fused_share_reader():
    from portbench.core import spec

    reader = spec.piece("metrics", "lift_fused_share.train")
    assert reader.read(None) is None
    with profile(activities=[ProfilerActivity.CPU]):
        spans.count("lift.pixels", 300)
        spans.count("lift.fused_pixels", 300)
        spans.count("lift.pixels", 100)
    assert reader.read(None) == pytest.approx(75.0)


# -- on the card ---------------------------------------------------------------------

def _step(v: torch.Tensor) -> torch.Tensor:
    """One bf16 step (2^-7 of the binade) at each value of v."""
    _, e = torch.frexp(v.float())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


CARD_CASES = {
    # name: (map shapes, cout)
    "resnet50_4": (map_shapes("resnet50", 4, (60, 80), 2.0), 32),
    "resnet18_3_odd": (map_shapes("resnet18", 3, (45, 61), 2.0), 32),
    "resnet18_2_cout8": (map_shapes("resnet18", 2, (45, 61), 1.0), 8),
    "resnet50_3_cout40": (map_shapes("resnet50", 3, (37, 53), 2.0), 40),
    "resnet18_2_cout256": (map_shapes("resnet18", 2, (30, 40), 1.0), 256),
    "stem_only_cout16": ([(3, 64, 17, 29)], 16),
    "five_maps": ([(2, 64, 33, 47), (2, 64, 17, 24), (2, 128, 9, 12), (2, 256, 5, 6),
                   (2, 512, 3, 3)], 32),
    # the VoxelNet benchmark cell's lift (frame_chunk 4 x batch 3 images of 480x640 at
    # feature_scale 2, 1,856 -> 32), and two of its images for the float64 referee
    "cell": (map_shapes("resnet50", 4, (480, 640), 2.0, N=12), 32),
    "cell_two_images": (map_shapes("resnet50", 4, (480, 640), 2.0), 32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_card_forward_matches_the_plain_bf16_path(cuda, case):
    shapes, cout = CARD_CASES[case]
    maps, weight, bias, _ = _inputs(shapes, cout, BF16, cuda)
    weight = weight.float()
    before = kernels.SPATIAL_LIFT.launches
    out = sl.spatial_lift_cuda(maps, weight, bias.float())
    plain = sl.spatial_lift_plain(maps, weight, bias.float())
    y = sl.spatial_lift_plain(maps, weight, torch.zeros_like(bias.float()))
    torch.cuda.synchronize()
    assert kernels.SPATIAL_LIFT.launches == before + 1
    assert out.dtype == BF16 and out.shape == plain.shape
    diff = (out.float() - plain.float()).abs()
    assert bool((diff <= _step(y) + _step(plain)).all()), float(diff.max())
    assert float((diff > 0).float().mean()) < 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["resnet50_4", "resnet18_3_odd", "resnet50_3_cout40",
                                  "cell_two_images"])
def test_card_gradients_judged_against_float64(cuda, case):
    shapes, cout = CARD_CASES[case]
    maps, weight, bias, g = _inputs(shapes, cout, BF16, cuda, seed=4)
    weight, bias, g = weight.float(), bias.float(), g.to(BF16)
    _, fused = _grads(sl.spatial_lift, maps, weight, bias, g)
    _, unfused = _grads(sl.spatial_lift_plain, maps, weight, bias, g)
    _, ref = _grads(lambda m, w, b: sl.spatial_lift_float64(m, w, b, BF16),
                    [m.double() for m in maps], weight.double(), bias.double(), g.double())
    names = ["weight", "bias"] + [f"map{i}" for i in range(len(maps))]
    for name, a, b, r in zip(names, fused, unfused, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert_nearer_float64(a.cpu().double().numpy(), b.cpu().double().numpy(),
                              r.cpu().numpy(), name, FACTOR)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["resnet50_4", "cell"])
def test_card_two_runs_bit_equal_and_launch_counts(cuda, case):
    shapes, cout = CARD_CASES[case]
    maps, weight, bias, g = _inputs(shapes, cout, BF16, cuda, seed=5)
    weight, bias, g = weight.float(), bias.float(), g.to(BF16)
    lift0, gather0 = kernels.SPATIAL_LIFT.launches, kernels.LIFT_RESIZE_T.launches
    runs = [_grads(sl.spatial_lift, maps, weight, bias, g) for _ in range(2)]
    torch.cuda.synchronize()
    (out_a, grads_a), (out_b, grads_b) = runs
    assert torch.equal(out_a, out_b)
    assert all(torch.equal(a, b) for a, b in zip(grads_a, grads_b))
    assert kernels.SPATIAL_LIFT.launches - lift0 == 2
    assert kernels.LIFT_RESIZE_T.launches - gather0 == 2 * (len(maps) - 1)


@pytest.mark.cuda
def test_card_batch_beyond_a_grid_dimension(cuda):
    """70,000 images (8 output channels: 560,000 gradient planes) run on
    grids that fold the images and planes into x (a grid's y stops at
    65,535): the forward within the forward tolerance of the plain path and
    the gather within float32 sums of the float64 transpose, and the last
    images' results bit-equal to the kernels run on those images alone."""
    N, cout, tail = 70000, 8, 3
    maps, weight, bias, g = _inputs([(N, 16, 6, 5), (N, 16, 3, 3)], cout, BF16, cuda, seed=8)
    weight, bias, g = weight.float(), bias.float(), g.to(BF16)
    out = sl.spatial_lift_cuda(maps, weight, bias)
    plain = sl.spatial_lift_plain(maps, weight, bias)
    y = sl.spatial_lift_plain(maps, weight, torch.zeros_like(bias))
    diff = (out.float() - plain.float()).abs()
    assert bool((diff <= _step(y) + _step(plain)).all()), float(diff.max())
    assert float((diff > 0).float().mean()) < 0.01
    assert torch.equal(out[-tail:], sl.spatial_lift_cuda([m[-tail:] for m in maps], weight, bias))
    G = sl.resize_transpose_cuda(g, (3, 3))
    ref = sl.resize_transpose_plain(g.double(), (3, 3), BF16)
    # each texel sums at most 4 x 4 taps of |g| < 6: f32 rounding stays below 1e-5
    assert float((G.double() - ref).abs().max()) < 1e-5
    assert torch.equal(G[-tail:], sl.resize_transpose_cuda(g[-tail:], (3, 3)))


@pytest.mark.cuda
@pytest.mark.parametrize("case, fused", [("bf16_proj", True), ("f32_proj", False),
                                         ("bf16_no_proj", False), ("bf16_nearest", False)])
def test_card_dispatch_and_counters(cuda, case, fused):
    enc = SpatialEncoder("resnet18", 1 if case == "bf16_nearest" else 3, feature_scale=2.0,
                         out_channels=None if case == "bf16_no_proj" else 32,
                         dtype=torch.float32 if case == "f32_proj" else BF16,
                         upsample_interp="nearest" if case == "bf16_nearest" else "bilinear")
    enc = enc.to(cuda)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 3, 23, 31))).float()
    before = kernels.SPATIAL_LIFT.launches
    with profile(activities=[ProfilerActivity.CPU]):
        out = enc(x.to(cuda))
        torch.cuda.synchronize()
    assert kernels.SPATIAL_LIFT.launches - before == int(fused)
    pixels = 2 * 23 * 31
    want = {"lift.pixels": pixels, **({"lift.fused_pixels": pixels} if fused else {})}
    assert spans.counters() == want
    if fused:  # the unfused code on the same maps, within the forward's tolerance
        with torch.no_grad():
            feats = enc.resnet(sl.resize_bilinear_align_corners(x.to(cuda), (46, 62)))
            plain = sl.spatial_lift_plain(feats, enc.proj.weight, enc.proj.bias)
            y = sl.spatial_lift_plain(feats, enc.proj.weight, torch.zeros_like(enc.proj.bias))
        assert out.dtype == BF16 and out.shape == plain.shape
        diff = (out.float() - plain.float()).abs()
        assert bool((diff <= _step(y) + _step(plain)).all()), float(diff.max())
        assert float((diff > 0).float().mean()) < 0.01


def test_lift_build_rows():
    """The ptxas parse and build gate chip_smoke.py runs find the lift's
    instances; a spill in either kernel, or the lift off wgmma, fails."""
    from gennerf_tpu_torch.tools import measure

    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119spatial_lift_kernelILi8EEEvNS_8LiftArgsE' for 'sm_90a'\n"
           "ptxas info    : Used 202 registers\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120lift_resize_t_kernelEPK13__nv_bfloat16PfPKiS5_iiii' for 'sm_90a'\n"
           "ptxas info    : Used 30 registers\n"
           "    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n")
    rows = measure.ptxas_rows(log)
    assert rows[("spatial_lift", 256)] == {"kernel": "spatial_lift", "rows": 256,
                                           "registers": 202, "spill_store_bytes": 0,
                                           "spill_load_bytes": 0}
    report = {"cuobjdump": "missing", "kernels": list(rows.values())}
    with pytest.raises(RuntimeError, match="lift kernel spills"):
        measure.check_build(report)
    rows[("lift_resize_t", None)].update(spill_store_bytes=0, spill_load_bytes=0)
    measure.check_build(report)
    report["cuobjdump"] = "cuobjdump"
    rows[("spatial_lift", 256)].update(hgmma=0, hmma=0)
    with pytest.raises(RuntimeError, match="not on wgmma"):
        measure.check_build(report)
    rows[("spatial_lift", 256)].update(hgmma=4)
    measure.check_build(report)
