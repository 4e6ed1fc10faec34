"""The decode kernels' weight packing (gennerf_tpu_torch/ops/weight_slabs.py)
on the CPU: every element of every slab maps back to its place in the
original matrix through `slab_address` (the layout csrc/resnet_tile.cuh's
wgmma descriptors read), and unpacking returns the weights exactly.

Widths are the kernels' (H 128, 256, 512) plus one the kernels do not take
(32, whose slabs only the CPU packing uses); depths are H and the padded
lin_in / lin_z depths, including ones that leave a short last slab.
Everything is exact: packing only moves bf16 values.
"""
import os
import re

import numpy as np
import pytest
import torch

from gennerf_tpu_torch.ops import weight_slabs as ws

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "gennerf_tpu_torch", "csrc", "resnet_tile.cuh")


def _bf16_matrix(K, H, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((K, H)).astype(np.float32)).to(torch.bfloat16)


def test_geometry_matches_the_kernels():
    """The Python geometry uses the tile constants of resnet_tile.cuh."""
    src = open(CSRC).read()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (const["kSlabBytes"], const["kNC"]) == (ws.SLAB_BYTES, ws.NC)
    # (G, CW, NC, KS): the column groups, columns a consumer, N-chunk, slab depth
    assert ws.slab_geometry(128) == (1, 128, 64, 128)
    assert ws.slab_geometry(256) == (1, 256, 64, 128)
    assert ws.slab_geometry(512) == (2, 256, 64, 64)
    for H in (128, 256, 512):
        G, _, nc, KS = ws.slab_geometry(H)
        assert KS * nc * G * 2 == ws.SLAB_BYTES


@pytest.mark.parametrize("H,K", [
    (128, 128), (128, 32), (128, 48), (128, 128 + 16),
    (256, 256), (256, 48), (256, 128),
    (512, 512), (512, 48), (512, 80), (512, 128),
    (32, 32), (32, 16),
])
def test_slab_address_maps_every_element(H, K):
    w = _bf16_matrix(K, H, seed=H + K)
    packed = ws.pack_slabs(w[None])[0]
    k, n = np.meshgrid(np.arange(K), np.arange(H), indexing="ij")
    addr = ws.slab_address(k, n, K, H)
    # a bijection onto the packed buffer, and each (k, n) lands on w[k, n]
    assert np.array_equal(np.sort(addr.ravel()), np.arange(K * H))
    assert torch.equal(packed[torch.from_numpy(addr)], w)
    assert torch.equal(ws.unpack_slabs(packed[None], K, H)[0], w)


@pytest.mark.parametrize("H,K", [(128, 48), (256, 256), (512, 80)])
def test_slab_address_follows_the_slab_layout(H, K):
    """Within each 16 KB slab, (k, n) sits in an 8x8 core matrix of 16-byte
    rows: 8 consecutive k of one output column share a 16-byte row, and the
    next k-group of a chunk is NC*8 elements on."""
    G, CW, nc, KS = ws.slab_geometry(H)
    k, n = np.meshgrid(np.arange(K), np.arange(H), indexing="ij")
    addr = ws.slab_address(k, n, K, H)
    assert np.array_equal(addr[1:8:1] - addr[0:7], np.ones((7, H), int))  # k contiguous by 8
    assert np.all(addr[8:min(K, KS)] - addr[:min(K, KS) - 8] == nc * 8)  # next core-matrix column
    assert np.all(addr[:, 1:8] - addr[:, :7] == 8)  # next output column: the next 16-byte row
    # each (chunk, slab) is one contiguous run of at most a stage's bytes,
    # the runs in chunk-then-slab order
    chunk = (n % CW) // nc
    slab = k // KS
    starts = []
    for c in range(CW // nc):
        for s_ in range((K + KS - 1) // KS):
            a = addr[(chunk == c) & (slab == s_)]
            assert a.max() - a.min() + 1 == a.size <= ws.SLAB_BYTES // 2
            starts.append(a.min())
    assert starts == sorted(starts) and starts[0] == 0


@pytest.mark.parametrize("H", [128, 256, 512])
@pytest.mark.parametrize("point", [False, True])
def test_unpack_returns_the_weights(H, point):
    nb, d_in, d_code = 3, 32, 39
    gen = torch.Generator().manual_seed(H)
    weights = {
        "w_in": torch.randn(d_in, H, generator=gen), "b_in": torch.randn(H, generator=gen),
        "wz": torch.randn(nb, d_code, H, generator=gen), "bz": torch.randn(nb, H, generator=gen),
        "w0": torch.randn(nb, H, H, generator=gen), "w1": torch.randn(nb, H, H, generator=gen),
        "b0": torch.randn(nb, H, generator=gen), "b1": torch.randn(nb, H, generator=gen),
        "w_last": torch.randn(H, generator=gen), "b_last": 0.1, "alpha": 0.7, "smoothing": 1.05,
    }
    packed = ws.pack_decode_weights(weights, point=point)
    depths = ws.schedule_depths(weights, point)
    assert depths == ([32] + [48, H, H] * nb if point else [H, H] * nb)
    assert packed["k_slabs"].shape == (sum(depths) * H,) and packed["k_slabs"].dtype == torch.bfloat16
    bf = torch.bfloat16
    expect = []
    if point:
        expect.append(weights["w_in"].to(bf))
    for b in range(nb):
        if point:
            expect.append(torch.cat([weights["wz"][b].to(bf), torch.zeros(48 - d_code, H, dtype=bf)]))
        expect += [weights["w0"][b].to(bf), weights["w1"][b].to(bf)]
    mats = ws.unpack_decode_weights(packed)
    assert len(mats) == len(expect)
    for m, e in zip(mats, expect):
        assert torch.equal(m, e)
    assert torch.equal(packed["k_w_last"], weights["w_last"].to(bf))
    assert torch.equal(packed["k_b0"], weights["b0"]) and torch.equal(packed["k_b1"], weights["b1"])
    assert ("k_b_in" in packed) == point and packed["k_schedule"] == ("point" if point else "grid")


def test_widths_without_a_slab_layout():
    """A width that is not a multiple of 8 gets the biases, and no slabs
    (the plain decode needs none and no kernel takes it)."""
    H, nb = 12, 1
    weights = {"w0": torch.zeros(nb, H, H), "w1": torch.zeros(nb, H, H), "b0": torch.zeros(nb, H),
               "b1": torch.zeros(nb, H), "w_last": torch.zeros(H)}
    packed = ws.pack_decode_weights(weights, point=False)
    assert "k_slabs" not in packed and packed["k_b0"].dtype == torch.float32
    with pytest.raises(ValueError, match="multiple of 8"):
        ws.slab_geometry(H)
    with pytest.raises(ValueError, match="multiple of 16"):
        ws.pack_slabs(torch.zeros(1, 24, 64))
