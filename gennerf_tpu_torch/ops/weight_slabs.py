"""The decode kernels' weight packing (csrc/resnet_tile.cuh).

Both decode kernels (csrc/grid_decode.cu, csrc/point_decode.cu) stream
their weight matrices through a ring of 16 KB shared-memory stages with 1D
bulk copies, so each matrix is packed once, on the host, into exactly the
bytes a stage receives: its slabs, in the order the kernel consumes them.

For a product of depth K (rows of the (in, out) matrix, a multiple of 16)
and width H, with G column groups (2 at H > 256, where the kernel's two
consumer warpgroups split the columns, else 1), CW = H / G columns a
group, N-chunks of NC = 64 columns (CW itself when that is not a multiple
of 64) and slabs of KS = 8192 / (NC * G) rows of K (rounded down to 16):
chunk by chunk, slab by slab (the last one of a chunk holds the K % KS
rows left), group by group, element (k, n) of a slab of ks rows sits at

    (k / 8) * NC * 8 + (n / 8) * 64 + (n % 8) * 8 + k % 8

with k and n counted from the slab's first row and the group's first
column of the chunk: 8x8 core matrices of 16-byte rows, the output columns
as the rows of the K-major wgmma B operand. `slab_address` is that map;
`pack_slabs` applies it to whole matrices and `unpack_slabs` inverts it.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

SLAB_BYTES = 16384
NC = 64
DEPTH_ALIGN = 16


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def slab_geometry(H: int) -> tuple:
    """(G, CW, NC, KS) of a width-H product (H a multiple of 8)."""
    if H % 8:
        raise ValueError(f"slab packing needs a width that is a multiple of 8, got {H}")
    G = 2 if H > 256 else 1
    CW = H // G
    nc = NC if CW % NC == 0 else CW
    KS = SLAB_BYTES // 2 // (nc * G) // DEPTH_ALIGN * DEPTH_ALIGN
    return G, CW, nc, KS


def slab_address(k, n, K: int, H: int):
    """Element offset of (k, n) of a (K, H) matrix in its packed slabs;
    k and n may be integer numpy arrays."""
    G, CW, nc, KS = slab_geometry(H)
    g, rem = np.divmod(n, CW)
    c, nl = np.divmod(rem, nc)
    s, kl = np.divmod(k, KS)
    ks = np.minimum(KS, K - s * KS)
    base = c * K * nc * G + s * KS * nc * G + g * ks * nc
    return base + (kl // 8) * nc * 8 + (nl // 8) * 64 + (nl % 8) * 8 + kl % 8


def pack_slabs(w: torch.Tensor) -> torch.Tensor:
    """(m, K, H) matrices -> (m, K*H): each matrix as its slabs."""
    m, K, H = w.shape
    if K % DEPTH_ALIGN:
        raise ValueError(f"slab packing needs a depth that is a multiple of {DEPTH_ALIGN}, got {K}")
    G, CW, nc, KS = slab_geometry(H)
    C = CW // nc
    parts = []
    for k0 in range(0, K, KS):
        ks = min(KS, K - k0)
        s = w[:, k0:k0 + ks].reshape(m, ks // 8, 8, G, C, nc // 8, 8)  # m kc kr g c ng nr
        parts.append(s.permute(0, 4, 3, 1, 5, 6, 2).reshape(m, C, -1))  # m c g kc ng nr kr
    return torch.cat(parts, dim=2).reshape(m, K * H)


def unpack_slabs(packed: torch.Tensor, K: int, H: int) -> torch.Tensor:
    """Inverse of `pack_slabs`: (m, K*H) -> (m, K, H)."""
    m = packed.shape[0]
    G, CW, nc, KS = slab_geometry(H)
    C = CW // nc
    chunks = packed.reshape(m, C, K * nc * G)
    w = torch.empty(m, K, H, dtype=packed.dtype, device=packed.device)
    for k0 in range(0, K, KS):
        ks = min(KS, K - k0)
        s = chunks[:, :, k0 * nc * G:(k0 + ks) * nc * G].reshape(m, C, G, ks // 8, nc // 8, 8, 8)
        w[:, k0:k0 + ks] = s.permute(0, 3, 6, 2, 1, 4, 5).reshape(m, ks, H)
    return w


def _padded(w: torch.Tensor, K: int) -> torch.Tensor:
    """bf16 copy of (..., k, H) with zero rows up to K."""
    out = torch.zeros(*w.shape[:-2], K, w.shape[-1], dtype=torch.bfloat16, device=w.device)
    out[..., :w.shape[-2], :] = w.to(torch.bfloat16)
    return out


def schedule_depths(weights: dict, point: bool) -> Sequence[int]:
    """The depth of each product in the order a kernel runs them: per block
    w0, w1 (grid decode), after lin_in and with lin_z before each block's
    pair (point decode); lin_in and lin_z at their 16-padded depths."""
    nb, H, _ = weights["w0"].shape
    if not point:
        return [H, H] * nb
    d_in_p = round_up(weights["w_in"].shape[0], DEPTH_ALIGN)
    d_code_p = round_up(weights["wz"].shape[1], DEPTH_ALIGN)
    return [d_in_p] + [d_code_p, H, H] * nb


@torch.no_grad()
def pack_decode_weights(weights: dict, point: bool) -> dict:
    """The decode kernels' form of `extract_resnetfc_weights`'s arrays,
    added to a copy of them: `k_slabs`, the bf16 matrices the kernel
    multiplies, each packed as its slabs, in the order of `schedule_depths`
    (`point` selects the point decode's products, else the grid decode's);
    f32 biases, bf16 w_last, and `k_schedule` naming the order. A width that
    is not a multiple of 8 has no slab layout and gets no `k_slabs`."""
    f32 = torch.float32
    nb, H, _ = weights["w0"].shape
    out = dict(weights, k_schedule="point" if point else "grid",
               k_w_last=weights["w_last"].to(torch.bfloat16).contiguous(),
               k_b0=weights["b0"].to(f32).contiguous(), k_b1=weights["b1"].to(f32).contiguous())
    if point:
        out["k_b_in"] = weights["b_in"].to(f32).contiguous()
        out["k_bz"] = weights["bz"].to(f32).contiguous()
    if H % 8:  # no slab layout (nor kernel) for this width: the plain decode needs none
        return out
    w01 = pack_slabs(torch.stack([weights["w0"], weights["w1"]], dim=1)
                     .reshape(2 * nb, H, H).to(torch.bfloat16)).reshape(nb, -1)
    if not point:
        out["k_slabs"] = w01.reshape(-1).contiguous()
        return out
    d_in_p, d_code_p = schedule_depths(weights, True)[:2]
    w_in = pack_slabs(_padded(weights["w_in"], d_in_p)[None])
    wz = pack_slabs(_padded(weights["wz"], d_code_p))
    out["k_slabs"] = torch.cat([w_in.reshape(-1), torch.cat([wz, w01], dim=1).reshape(-1)])
    return out


def unpack_decode_weights(packed: dict) -> list:
    """The (K, H) bf16 matrices of `k_slabs`, in schedule order."""
    depths = schedule_depths(packed, packed["k_schedule"] == "point")
    H = packed["w0"].shape[-1]
    mats, off = [], 0
    for K in depths:
        mats.append(unpack_slabs(packed["k_slabs"][off:off + K * H][None], K, H)[0])
        off += K * H
    if off != packed["k_slabs"].numel():
        raise ValueError("k_slabs does not match its schedule")
    return mats
