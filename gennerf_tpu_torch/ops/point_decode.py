"""Arbitrary-point TSDF decode (counterpart of
gennerf_tpu/ops/pallas/fused_decoder.py, point part: `extract_resnetfc_weights`,
`fused_resnetfc_tsdf`, `supports_fused_decode`).

Per point, from its triplane feature (N, d_in) and positional code
(N, d_code), the whole ResnetFC and the folded tanh head:
    x = feat @ w_in + b_in
    per block b: x += alpha * (code @ wz_b + bz_b); x += residual block
    tsdf = tanh(relu(x) . w_last + b_last) * smoothing
CUDA tensors go to the kernel csrc/point_decode.cu (the port of `_kernel`),
CPU tensors to `fused_resnetfc_tsdf_plain` with bf16 feeds (the TPU tier's
only numerics). The weights are `grid_decode.extract_resnetfc_weights`'s,
packed once by `pack_point_weights`.
"""
from __future__ import annotations

import torch

from . import kernels
from .grid_decode import _feed, supports_grid_decode
from .weight_slabs import pack_decode_weights, schedule_depths

# the point kernel takes the same decoder as the grid kernel
supports_fused_decode = supports_grid_decode

KERNEL_WIDTHS = (128, 256, 512)
MAX_INPUT_WIDTH = 128


def pack_point_weights(weights: dict) -> dict:
    """The point decode's form of `extract_resnetfc_weights`'s arrays
    (`weight_slabs.pack_decode_weights` with the point schedule)."""
    return pack_decode_weights(weights, point=True)


def _check_inputs(feat: torch.Tensor, code: torch.Tensor, weights: dict) -> None:
    d_in, H = weights["w_in"].shape
    d_code = weights["wz"].shape[1]
    for name, t, d in (("feat", feat, d_in), ("code", code, d_code)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: expected torch.float32, got {t.dtype}")
        if t.dim() != 2 or t.shape[1] != d:
            raise ValueError(f"{name}: expected shape (N, {d}), got {tuple(t.shape)}")
    if code.shape[0] != feat.shape[0]:
        raise ValueError(f"feat has {feat.shape[0]} rows, code {code.shape[0]}")


@torch.no_grad()
def fused_resnetfc_tsdf_plain(feat: torch.Tensor, code: torch.Tensor, weights: dict,
                              bf16_feeds: bool = True, chunk: int = 1 << 18) -> torch.Tensor:
    """Plain PyTorch decode of (N, d_in) features and (N, d_code) codes ->
    (N,) f32, `chunk` points at a time (the semantics of `_mlp_tail`).

    bf16_feeds=True rounds every product input (feat, code, activations and
    weights) to bf16 with f32 accumulation, as the kernel and the TPU kernel
    do; False runs true f32 products."""
    _check_inputs(feat, code, weights)
    w_in = _feed(weights["w_in"], bf16_feeds)
    wz = _feed(weights["wz"], bf16_feeds)
    w0 = _feed(weights["w0"], bf16_feeds)
    w1 = _feed(weights["w1"], bf16_feeds)
    w_last = _feed(weights["w_last"], bf16_feeds)[:, None]
    b_in, bz, b0, b1 = weights["b_in"], weights["bz"], weights["b0"], weights["b1"]
    alpha = weights["alpha"]
    out = torch.empty(feat.shape[0], dtype=torch.float32, device=feat.device)
    for s in range(0, feat.shape[0], chunk):
        f = _feed(feat[s:s + chunk], bf16_feeds)
        c = _feed(code[s:s + chunk], bf16_feeds)
        x = f @ w_in + b_in
        for b in range(w0.shape[0]):
            x = x + alpha * (c @ wz[b] + bz[b])
            net = _feed(torch.relu(x), bf16_feeds) @ w0[b] + b0[b]
            x = x + (_feed(torch.relu(net), bf16_feeds) @ w1[b] + b1[b])
        head = (_feed(torch.relu(x), bf16_feeds) @ w_last)[:, 0]
        out[s:s + chunk] = torch.tanh(head + weights["b_last"]) * weights["smoothing"]
    return out


@torch.no_grad()
def fused_resnetfc_tsdf_cuda(feat: torch.Tensor, code: torch.Tensor, weights: dict) -> torch.Tensor:
    """The point-decode kernel (K3) on CUDA inputs; `weights` from
    `pack_point_weights`. -> (N,) f32."""
    _check_inputs(feat, code, weights)
    n, d_in = feat.shape
    d_code = code.shape[1]
    nb, H, _ = weights["w0"].shape
    if H not in KERNEL_WIDTHS:
        raise NotImplementedError(f"point decode kernel takes d_hidden 128, 256 or 512, got {H}")
    if max(d_in, d_code) > MAX_INPUT_WIDTH:
        raise NotImplementedError(
            f"point decode kernel takes d_in, d_code <= {MAX_INPUT_WIDTH}, got {d_in}, {d_code}")
    f32, bf16 = torch.float32, torch.bfloat16
    kernels.check_cuda_tensor(feat, "feat", f32)
    kernels.check_cuda_tensor(code, "code", f32)
    if weights.get("k_schedule") != "point":
        raise ValueError("point decode takes pack_point_weights(weights)")
    depths = schedule_depths(weights, point=True)
    d_in_p, d_code_p = depths[:2]
    for name, dtype, shape in (("k_slabs", bf16, (sum(depths) * H,)), ("k_b_in", f32, (H,)),
                               ("k_bz", f32, (nb, H)), ("k_b0", f32, (nb, H)),
                               ("k_b1", f32, (nb, H)), ("k_w_last", bf16, (H,))):
        kernels.check_cuda_tensor(weights[name], name, dtype, shape)
    out = torch.empty(n, dtype=f32, device=feat.device)
    w = weights
    kernels.POINT_DECODE.launch(
        feat.data_ptr(), code.data_ptr(), n, d_in, d_in_p, d_code, d_code_p,
        w["k_slabs"].data_ptr(), w["k_b_in"].data_ptr(), w["k_bz"].data_ptr(),
        w["k_b0"].data_ptr(), w["k_b1"].data_ptr(), w["k_w_last"].data_ptr(),
        float(w["alpha"]), float(w["b_last"]), float(w["smoothing"]),
        out.data_ptr(), nb, H, kernels.stream_ptr(feat.device),
    )
    return out


def fused_resnetfc_tsdf(feat: torch.Tensor, code: torch.Tensor, weights: dict) -> torch.Tensor:
    """Decode arbitrary points: the kernel for CUDA inputs, the plain
    bf16-feed version for CPU inputs. `weights` from `pack_point_weights`."""
    device = feat.device
    if device.type == "cuda":
        return fused_resnetfc_tsdf_cuda(feat, code, weights)
    if device.type == "cpu":
        return fused_resnetfc_tsdf_plain(feat, code, weights, bf16_feeds=True)
    raise ValueError(f"unsupported device {device}")


def point_decode_flops(n: int, d_in: int, d_code: int, H: int, n_blocks: int) -> int:
    """Work of the decode at unpadded widths: lin_in, per block lin_z and
    two H x H products, and the head's H-long dot."""
    return n * 2 * (d_in * H + n_blocks * (d_code * H + 2 * H * H) + H)
