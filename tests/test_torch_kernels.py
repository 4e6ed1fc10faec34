"""The port's CUDA kernels (csrc/fps.cu, csrc/grid_decode.cu,
csrc/point_decode.cu) against their plain PyTorch versions, and their
wrappers' checks (the weight packing's own tests: test_torch_packing.py).

This file imports torch, the port and chip_smoke.py (the scene of the depth
clouds) only, so on the machine with the card (which has no JAX) it runs
without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Tests that launch a kernel carry the `cuda` marker and skip, in their
`cuda` fixture, when there is no CUDA device (a CUDA kernel has no CPU
mode); the wrapper and build checks run everywhere.
Tolerances: FPS indices are identical. The grid and point decodes agree
with their bf16-feed plain versions within 5e-2 at any point and 1e-3 on
average: both round the same values to bf16 and accumulate in f32 in
another order, so a few activations round the other way (one bf16 step,
2^-8 of the value).
"""
import functools
import os
import sys

import numpy as np
import pytest
import torch

from gennerf_tpu_torch.ops import kernels
from gennerf_tpu_torch.ops import grid_decode as gd
from gennerf_tpu_torch.ops import point_decode as pd
from gennerf_tpu_torch.ops import sampling as tsamp
from gennerf_tpu_torch.ops import weight_slabs as ws

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _fps_cloud(kind, B, N, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "depth":  # presampled depth clouds of 8 rendered 120x160 frames (duplicates, ties)
        cloud = _ring_cloud()
        sel = rng.integers(0, cloud.shape[1], (B, N))
        return np.take_along_axis(cloud[np.arange(B) % len(cloud)], sel[..., None], 1)
    if kind == "random":
        return rng.standard_normal((B, N, 3)).astype(np.float32)
    if kind == "duplicates":  # a presample with replacement of a smaller cloud
        base = rng.standard_normal((B, max(N // 4, 1), 3)).astype(np.float32)
        sel = rng.integers(0, base.shape[1], (B, N))
        return np.take_along_axis(base, sel[..., None], 1)
    if kind == "identical":  # every distance ties
        return np.ones((B, N, 3), np.float32)
    raise ValueError(kind)


@functools.lru_cache(maxsize=1)
def _ring_cloud():
    """The (8, 19200, 3) depth clouds of chip_smoke.py's scene: 8 ring
    frames around a sphere and a box."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke.ring_clouds(torch).numpy()


# -- checks that run without a card -----------------------------------------

def test_import_builds_nothing(tmp_path):
    """Importing every module of the port starts no build."""
    import subprocess
    import sys

    code = ("import importlib, pkgutil, gennerf_tpu_torch\n"
            "for m in pkgutil.walk_packages(gennerf_tpu_torch.__path__, 'gennerf_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "from gennerf_tpu_torch.ops import kernels\n"
            "print(kernels._lib, kernels.build_info)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, GENNERF_TORCH_BUILD_DIR=str(tmp_path / "build"))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "None {}" and not (tmp_path / "build").exists()


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("GENNERF_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    assert kernels.build_dir() == str(tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build_library()


def test_wrappers_reject_cpu_tensors():
    xyz = torch.zeros(2, 64, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tsamp.fps_cuda(xyz, 8, torch.zeros(2, dtype=torch.int32))
    H = 128
    tables = gd.GridTables(torch.zeros(6, H), torch.zeros(2, 3, H), torch.zeros(2, 2, H),
                           torch.zeros(2, 1, H), torch.zeros(1, 2, H), torch.zeros(1, 3, H))
    with pytest.raises(ValueError, match="CUDA tensor"):
        gd.grid_decode_cuda(tables, {})


def test_grid_kernel_widths():
    tables = gd.GridTables(*(torch.zeros(1, 1, 96) for _ in range(6)))
    with pytest.raises(NotImplementedError, match="d_hidden"):
        gd.grid_decode_cuda(tables, {})


def test_other_devices_raise():
    meta = torch.zeros(2, 16, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsamp.farthest_point_sample(meta, 4, start=torch.zeros(2, dtype=torch.int32))
    w = _point_weights(128, 1, 8, 9, torch.device("cpu"))
    with pytest.raises(ValueError, match="unsupported device"):
        pd.fused_resnetfc_tsdf(torch.zeros(4, 8, device="meta"), torch.zeros(4, 9, device="meta"), w)


def _point_weights(H, nb, d_in, d_code, device, seed=0):
    """Random packed point-decode weights in extract_resnetfc_weights' form."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(device)

    return pd.pack_point_weights({
        "w_in": rnd(d_in, H, scale=d_in ** -0.5), "b_in": rnd(H, scale=0.1),
        "wz": rnd(nb, d_code, H, scale=d_code ** -0.5), "bz": rnd(nb, H, scale=0.1),
        "w0": rnd(nb, H, H, scale=H ** -0.5), "w1": rnd(nb, H, H, scale=H ** -0.5),
        "b0": rnd(nb, H, scale=0.1), "b1": rnd(nb, H, scale=0.1),
        "w_last": rnd(H, scale=H ** -0.5), "b_last": 0.05, "alpha": 0.7, "smoothing": 1.05})


@pytest.mark.parametrize("feat_shape,code_shape,dtype,match", [
    ((5, 8), (5, 9), torch.float64, "float32"),
    ((5, 9), (5, 9), torch.float32, "shape"),
    ((5, 8), (4, 9), torch.float32, "rows"),
    ((5, 8), (5, 9), torch.float32, "CUDA tensor"),
])
def test_point_decode_wrapper_checks(feat_shape, code_shape, dtype, match):
    w = _point_weights(128, 1, 8, 9, torch.device("cpu"))
    feat, code = torch.zeros(feat_shape, dtype=dtype), torch.zeros(code_shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        pd.fused_resnetfc_tsdf_cuda(feat, code, w)
    if match != "CUDA tensor":  # the dispatching wrapper checks the same on the CPU
        with pytest.raises(ValueError, match=match):
            pd.fused_resnetfc_tsdf(feat, code, w)


@pytest.mark.parametrize("H,d_in,d_code", [(96, 8, 9), (128, 130, 9), (128, 8, 129)])
def test_point_kernel_limits(H, d_in, d_code):
    w = _point_weights(H, 1, d_in, d_code, torch.device("cpu"))
    with pytest.raises(NotImplementedError):
        pd.fused_resnetfc_tsdf_cuda(torch.zeros(3, d_in), torch.zeros(3, d_code), w)


def _plans(active, tiers=None):
    """fps_plan answers: clusters the card runs at once and the tier, by size."""
    tiers = tiers or {}
    return {cl: {"active_clusters": n, "tier": kernels.FPS_TIERS[tiers.get(cl, 0)]}
            for cl, n in zip(tsamp.FPS_CLUSTERS, active)}


# clusters of (1, 2, 4, 8, 16) CTAs the H100 ran at once at (N 16384, 256 threads)
H100_16384 = (132, 66, 62, 62, 35)


@pytest.mark.parametrize("B,active,tiers,expect", [
    (8, H100_16384, {1: 1}, 8),       # the predict shape: 8 (16 fits too, and is slower)
    (32, H100_16384, {1: 1}, 8),      # a training batch
    (64, H100_16384, {1: 1}, 2),      # 64 clusters of 4 do not fit at once
    (8, (132, 66, 62, 62, 7), {1: 2, 2: 2, 4: 2, 8: 2, 16: 1}, 8),  # 8 clusters of 16 do not fit
    (1, (528, 264, 124, 62, 7), {1: 2, 2: 2, 4: 2, 8: 2, 16: 1}, 16),  # a 640x480 frame: 16 for shared memory
    (1, (132, 66, 62, 62, 35), {}, 8),
    (200, H100_16384, {1: 1}, 2),     # no size fits: the smallest in registers
    (200, (132, 66, 33, 16, 7), {1: 2, 2: 2, 4: 2, 8: 2, 16: 2}, 1),
    (4, (132, 66, 62, 0, 0), {}, 4),  # sizes the card cannot run are skipped
])
def test_fps_choose_cluster(B, active, tiers, expect):
    assert tsamp.choose_cluster(B, _plans(active, tiers)) == expect


def test_fps_choose_cluster_none_runs():
    with pytest.raises(RuntimeError, match="no FPS cluster"):
        tsamp.choose_cluster(4, _plans((0, 0, 0, 0, 0)))


@pytest.mark.parametrize("N,npoint,cluster,match", [
    (10, 11, 0, "npoint"),
    (10, 0, 0, "npoint"),
    (10, -1, 0, "npoint"),
    (10, 4, 3, "cluster"),
    (10, 4, 32, "cluster"),
    (10, 4, 16, "CUDA tensor"),
])
def test_fps_wrapper_checks(N, npoint, cluster, match):
    with pytest.raises(ValueError, match=match):
        tsamp.fps_cuda(torch.zeros(2, N, 3), npoint, torch.zeros(2, dtype=torch.int32), cluster)


def test_fps_build_rows():
    """The ptxas parse and the build gate chip_smoke.py runs: every FPS
    instance found, a spill in any of them fails the build."""
    from gennerf_tpu_torch.tools import measure

    log = ("ptxas info    : Compiling entry function '_ZN34_GLOBAL__N__fps_cu_bc431931_1234514fps_reg_kernelILi4EEEvPKfPKiPiPfiii' for 'sm_90a'\n"
           "ptxas info    : Used 40 registers\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115fps_loop_kernelEPKfPKiPiPfiii' for 'sm_90a'\n"
           "    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
           "ptxas info    : Used 38 registers\n"
           "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110fps_kernelILi16EEEvPKfPKiPiiii' for 'sm_90a'\n"
           "ptxas info    : Used 30 registers\n"
           "ptxas info    : Compiling entry function '_Z18grid_decode_kernelILi256EEvv' for 'sm_90a'\n"
           "ptxas info    : Used 168 registers\n")
    fps = [{"kernel": "fps", "instance": "fps_reg_kernel<4>", "registers": 40,
            "spill_store_bytes": 0, "spill_load_bytes": 0},
           {"kernel": "fps", "instance": "fps_loop_kernel", "registers": 38,
            "spill_store_bytes": 4, "spill_load_bytes": 8},
           {"kernel": "fps", "instance": "fps_kernel<16>", "registers": 30}]
    rows = measure.ptxas_rows(log)
    assert [r for r in rows.values() if r["kernel"] == "fps"] == fps
    assert rows[("grid_decode", 256)] == {"kernel": "grid_decode", "H": 256, "registers": 168}
    report = {"cuobjdump": "missing", "kernels": list(rows.values())}
    with pytest.raises(RuntimeError, match="fps kernel spills"):
        measure.check_build(report)
    rows[("fps", "fps_loop_kernel")].update(spill_store_bytes=0, spill_load_bytes=0)
    measure.check_build(report)


def test_point_weights_packing():
    w = _point_weights(128, 2, 8, 39, torch.device("cpu"))
    assert w["k_schedule"] == "point" and w["k_slabs"].dtype == w["k_w_last"].dtype == torch.bfloat16
    mats = ws.unpack_decode_weights(w)
    assert [tuple(m.shape) for m in mats] == [(16, 128)] + [(48, 128), (128, 128), (128, 128)] * 2
    assert not mats[0][8:].any() and not mats[1][39:].any() and not mats[4][39:].any()
    assert torch.equal(mats[1][:39], w["wz"][0].to(torch.bfloat16))
    assert torch.equal(mats[6], w["w1"][1].to(torch.bfloat16))


# -- kernels on the card ----------------------------------------------------

FPS_CASES = [
    ("random", 1, 100, 7),
    ("random", 3, 1000, 64),
    ("duplicates", 8, 16384, 256),   # the predict shape
    ("duplicates", 32, 16384, 256),  # a training batch of 4 x 8 frames
    ("depth", 8, 16384, 256),        # the predict shape on rendered depth clouds
    ("depth", 32, 16384, 256),       # the training batch's
    ("duplicates", 2, 20000, 128),
    ("random", 1, 32768, 32),
    ("random", 1, 307200, 32),       # a 640x480 frame without presample
    ("identical", 2, 3000, 16),      # every distance ties
    ("random", 2, 1, 1),             # N = 1
    ("random", 2, 700, 700),         # npoint = N
    ("random", 3, 5, 4),             # fewer points than CTAs: some own none
    ("duplicates", 2, 2500, 40),     # fewer points than a cluster has threads
]


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [0, 1, 2, 4, 8, 16])
@pytest.mark.parametrize("kind,B,N,npoint", FPS_CASES)
def test_fps_kernel_matches_plain(cuda, kind, B, N, npoint, cluster):
    x = torch.from_numpy(_fps_cloud(kind, B, N)).to(cuda)
    start = torch.randint(0, N, (B,), dtype=torch.int32, device=cuda)
    k = tsamp.fps_cuda(x, npoint, start, cluster)
    torch.cuda.synchronize()
    p = tsamp.farthest_point_sample_plain(x, npoint, start)
    assert k.dtype == torch.int32 and k.shape == (B, npoint)
    assert torch.equal(k, p), int((k != p).sum())


@pytest.mark.cuda
def test_fps_kernel_limits(cuda):
    start = torch.zeros(1, dtype=torch.int32, device=cuda)
    for npoint in (11, 0, -3):
        with pytest.raises(ValueError, match="npoint"):
            tsamp.fps_cuda(torch.zeros(1, 10, 3, device=cuda), npoint, start)
    with pytest.raises(ValueError, match="cluster"):
        tsamp.fps_cuda(torch.zeros(1, 10, 3, device=cuda), 4, start, cluster=3)
    x = torch.from_numpy(_fps_cloud("random", 1, 40000)).to(cuda)  # past the old 32768 cap
    k = tsamp.fps_cuda(x, 8, start)
    assert torch.equal(k, tsamp.farthest_point_sample_plain(x, 8, start))


@pytest.mark.cuda
def test_fps_plan(cuda):
    """The launcher's plan: registers at the predict shape, then shared and
    device memory as the slice grows; every cluster size runs at least once;
    the wrapper records the plan it launched."""
    plans = {cl: kernels.fps_plan(16384, cl) for cl in tsamp.FPS_CLUSTERS}
    assert all(p["active_clusters"] >= 1 for p in plans.values()), plans
    # 16384 points on one CTA are past the register tier; split in 2 or more they are not
    assert plans[1]["tier"] == "shared memory" and plans[1]["scratch_per_cloud"] == 16384
    assert all(p["tier"] == "registers" and p["scratch_per_cloud"] == 0
               for cl, p in plans.items() if cl > 1)
    assert kernels.fps_plan(307200, 16)["tier"] != "registers"
    deep = kernels.fps_plan(307200, 1)
    assert deep["tier"] == "device memory" and deep["scratch_per_cloud"] == 307200
    cl = tsamp.choose_cluster(8, plans)
    assert cl > 1
    x = torch.from_numpy(_fps_cloud("random", 8, 16384)).to(cuda)
    tsamp.fps_cuda(x, 4, torch.zeros(8, dtype=torch.int32, device=cuda))
    assert kernels.FPS.last_launch == dict(plans[cl], cluster=cl, ctas=8 * cl)


@pytest.mark.cuda
def test_fps_wrapper_counts_launches(cuda):
    x = torch.from_numpy(_fps_cloud("random", 2, 500)).to(cuda)
    kernels.reset_launch_counts()
    sampled, idx = tsamp.farthest_point_sample(x, 16, torch.Generator().manual_seed(0))
    assert kernels.FPS.launches == 1 and kernels.GRID_DECODE.launches == 0
    torch.testing.assert_close(sampled, torch.gather(x, 1, idx.long()[..., None].expand(2, 16, 3)))


def _grid_case(H, nb, dims, device):
    """Random grid tables and packed grid-decode weights."""
    gen = torch.Generator().manual_seed(H + nb)
    nx, ny, nz = dims

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(device)

    weights = ws.pack_decode_weights(
        {"w0": rnd(nb, H, H, scale=H ** -0.5), "w1": rnd(nb, H, H, scale=H ** -0.5),
         "b0": rnd(nb, H, scale=0.1), "b1": rnd(nb, H, scale=0.1),
         "w_last": rnd(H, scale=H ** -0.5), "b_last": 0.05, "smoothing": 1.05}, point=False)
    tables = gd.GridTables(rnd(ny * nz, H), rnd(nx, nz, H), rnd(nx, ny, H),
                           rnd(nx, nb, H, scale=0.3), rnd(nb, ny, H, scale=0.3),
                           rnd(nb, nz, H, scale=0.3))
    return tables, weights


@pytest.mark.cuda
@pytest.mark.parametrize("H,nb,dims", [
    (128, 2, (5, 7, 9)),
    (256, 5, (3, 4, 11)),
    (256, 1, (17, 9, 13)),
    (512, 2, (2, 3, 7)),
    # tiles of 128 (64 at H 512) points spanning several (i, j) lines, nz not dividing the tile
    (128, 3, (3, 5, 56)),
    (256, 5, (3, 5, 56)),
    (512, 1, (3, 5, 56)),
    (256, 2, (2, 3, 7)),      # one ragged tile
    (256, 5, (96, 96, 56)),   # the full-width decoder at seqs_multigeo_4cm's test grid
])
def test_grid_decode_kernel_matches_plain(cuda, H, nb, dims):
    tables, weights = _grid_case(H, nb, dims, cuda)
    kernels.reset_launch_counts()
    k = gd.grid_decode(tables, weights)
    torch.cuda.synchronize()
    assert kernels.GRID_DECODE.launches == 1
    p = gd.separable_grid_decode_plain(tables, weights, bf16_feeds=True)
    err = (k - p).abs()
    assert k.shape == dims and torch.isfinite(k).all()
    assert err.max() < 5e-2 and err.mean() < 1e-3, (float(err.max()), float(err.mean()))
    assert (p - gd.separable_grid_decode_plain(tables, weights, bf16_feeds=False)).abs().mean() > err.mean()


@pytest.mark.cuda
def test_decode_wrappers_check_schedule(cuda):
    tables, grid_w = _grid_case(128, 1, (2, 2, 3), cuda)
    point_w = _point_weights(128, 1, 8, 9, cuda)
    with pytest.raises(ValueError, match="point=False"):
        gd.grid_decode_cuda(tables, point_w)
    with pytest.raises(ValueError, match="pack_point_weights"):
        pd.fused_resnetfc_tsdf_cuda(torch.zeros(3, 8, device=cuda), torch.zeros(3, 9, device=cuda),
                                    dict(grid_w, w_in=point_w["w_in"], wz=point_w["wz"]))


@pytest.mark.cuda
def test_decode_wrappers_count_launches(cuda):
    tables, grid_w = _grid_case(256, 2, (3, 5, 56), cuda)
    point_w = _point_weights(256, 2, 32, 39, cuda)
    feat, code = torch.randn(300, 32, device=cuda), torch.randn(300, 39, device=cuda)
    kernels.reset_launch_counts()
    for _ in range(2):
        gd.grid_decode(tables, grid_w)
    for _ in range(3):
        pd.fused_resnetfc_tsdf(feat, code, point_w)
    torch.cuda.synchronize()
    assert (kernels.FPS.launches, kernels.GRID_DECODE.launches, kernels.POINT_DECODE.launches) == (0, 2, 3)
    gd.separable_grid_decode_plain(tables, grid_w, bf16_feeds=True)
    pd.fused_resnetfc_tsdf_plain(feat, code, point_w)
    assert (kernels.GRID_DECODE.launches, kernels.POINT_DECODE.launches) == (2, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("H,nb,d_in,d_code,N", [
    (128, 2, 8, 39, 1000),      # ragged tail (TM 128)
    (256, 5, 32, 39, 19200),    # a secant launch of one 120x160 view
    (256, 5, 32, 39, 777),
    (256, 3, 16, 21, 65),       # one point past a full tile
    (512, 2, 128, 128, 300),    # widest inputs
    (128, 1, 128, 128, 257),    # the largest code tile at TM 128
    # tile edges (TM 128 at H <= 256, 64 at H 512)
    (256, 5, 32, 39, 1),
    (256, 5, 32, 39, 127),
    (256, 5, 32, 39, 128),
    (256, 5, 32, 39, 129),
    (512, 2, 32, 39, 129),
    (128, 2, 32, 39, 19200),
    (256, 2, 128, 128, 129),    # the most shared memory (128-wide code tile at H 256)
    (512, 1, 80, 72, 65),       # lin_in and lin_z deeper than an H-512 slab (64)
    (256, 5, 32, 39, 1 << 20),  # the full-width decoder at 2^20 points
])
def test_point_decode_kernel_matches_plain(cuda, H, nb, d_in, d_code, N):
    w = _point_weights(H, nb, d_in, d_code, cuda, seed=H + nb + N)
    gen = torch.Generator().manual_seed(N)
    feat = torch.randn(N, d_in, generator=gen).to(cuda)
    code = torch.randn(N, d_code, generator=gen).to(cuda)
    kernels.reset_launch_counts()
    k = pd.fused_resnetfc_tsdf(feat, code, w)
    torch.cuda.synchronize()
    assert kernels.POINT_DECODE.launches == 1 and kernels.GRID_DECODE.launches == 0
    p = pd.fused_resnetfc_tsdf_plain(feat, code, w, bf16_feeds=True)
    err = (k - p).abs()
    assert k.shape == (N,) and torch.isfinite(k).all()
    assert err.max() < 5e-2 and err.mean() < 1e-3, (float(err.max()), float(err.mean()))
    f32 = pd.fused_resnetfc_tsdf_plain(feat, code, w, bf16_feeds=False)
    assert (p - f32).abs().mean() > err.mean()


@pytest.mark.cuda
@pytest.mark.parametrize("H", [128, 256, 512])
def test_point_decode_kernel_zero_code(cuda, H):
    """With code 0 every lin_z injection is alpha * bz."""
    w = _point_weights(H, 5, 32, 39, cuda, seed=3)
    feat = torch.randn(500, 32, generator=torch.Generator().manual_seed(1)).to(cuda)
    code = torch.zeros(500, 39, device=cuda)
    k = pd.fused_resnetfc_tsdf_cuda(feat, code, w)
    torch.cuda.synchronize()
    p = pd.fused_resnetfc_tsdf_plain(feat, code, w, bf16_feeds=True)
    err = (k - p).abs()
    assert err.max() < 5e-2 and err.mean() < 1e-3, (float(err.max()), float(err.mean()))


@pytest.mark.cuda
@pytest.mark.parametrize("scenes", [1, 4])  # FPS at (8, 16384) and (32, 16384)
def test_train_step_with_fps_kernel_matches_plain(cuda, scenes):
    """One full-width train step (seqs_multigeo_4cm) with K1 in the encode
    against the same step with the plain FPS, same weights and draws: the
    indices are identical, so only the order of the scatter_add atomics
    differs (loss within 1e-5 relative, every gradient within 1e-4 of its
    tensor's largest magnitude)."""
    from unittest import mock

    from gennerf_tpu_torch.data.synthetic import training_batch
    from gennerf_tpu_torch.models import gen_nerf as gen_nerf_module
    from gennerf_tpu_torch.predict import build_model
    from gennerf_tpu_torch.train.step import StepDraws, batch_to_device, gen_nerf_forward_loss
    from gennerf_tpu_torch.utils.config import load_experiment_model_config

    torch.backends.cudnn.allow_tf32 = False
    cfg_dict = load_experiment_model_config(
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "configs", "experiment", "seqs_multigeo_4cm.yaml"))
    model = build_model(cfg_dict, cuda, seed=scenes)
    cfg = model.cfg
    batch = batch_to_device(training_batch(scenes, 8, 120, 160, cfg.voxel_dim_train,
                                           cfg.voxel_size, seed=scenes), cuda)
    BT, HW, presample = 8 * scenes, 120 * 160, cfg.encoder.pointnet.fps_presample
    g = torch.Generator(device=cuda).manual_seed(scenes)
    draws = StepDraws(sel=torch.randint(0, HW, (BT, presample), generator=g, device=cuda),
                      start=torch.randint(0, presample, (BT,), generator=g, device=cuda),
                      scores=torch.rand((BT, HW), generator=g, device=cuda),
                      noise=torch.randn((BT, cfg.ray.num_rays, cfg.ray.M), generator=g,
                                        device=cuda))

    def plain_fps(xyz, npoint, generator=None, start=None):
        idx = tsamp.farthest_point_sample_plain(xyz, npoint, start)
        return torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3)), idx

    def step():
        model.zero_grad(set_to_none=True)
        loss, _ = gen_nerf_forward_loss(model, batch, draws=draws)
        loss.backward()
        return float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters()}

    kernels.reset_launch_counts()
    loss_k, grads_k = step()
    assert kernels.FPS.launches == 1
    with mock.patch.object(gen_nerf_module, "farthest_point_sample", plain_fps):
        loss_p, grads_p = step()
    assert kernels.FPS.launches == 1
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p) and np.isfinite(loss_p)
    for name, gp in grads_p.items():
        err = float((grads_k[name] - gp).abs().max())
        assert err <= 1e-4 * float(gp.abs().max()), (name, err)
