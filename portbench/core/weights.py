"""Seeded weights, made by the benchmark on the device in one large draw and
handed alike to the program and to the plain reference.

The names and shapes come from the program's state dict; the values are
the benchmark's own: one uniform draw from a `torch.Generator` on the
device, cut into the parameters in state-dict order. Matrices and
convolution kernels take variance 1 / fan-in (halved in scale on the
second layer of a residual block), which keeps GenNerf's TSDF head off
its saturation (He's 2 / fan-in drives the pointnet planes to a standard
deviation of ~40 and every tanh to +-1); biases are uniform in +-0.1, norm scales 1 +- 0.1, a scalar
parameter 1 (ResnetFC's alpha). BatchNorm buffers start at mean 0,
variance 1, no batches.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

BIAS = 0.1
GAIN = 3.0  # uniform in +-sqrt(GAIN / fan-in): variance 1 / fan-in


def _fan_in(module: nn.Module, shape) -> int:
    if isinstance(module, nn.ConvTranspose2d) or isinstance(module, nn.ConvTranspose3d):
        # each output sums in_channels * prod(kernel) / prod(stride) inputs
        k = math.prod(shape[2:])
        s = math.prod(module.stride)
        return max(1, shape[0] * k // s)
    return max(1, math.prod(shape[1:]))


def _plan(model: nn.Module):
    """[(state-dict name, shape, dtype, rule, scale)] in state-dict order."""
    owner = {}
    for mname, module in model.named_modules():
        for pname, _ in module.named_parameters(recurse=False):
            owner[f"{mname}.{pname}" if mname else pname] = module
    plan = []
    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        shape = tuple(t.shape)
        if name not in owner:  # a buffer
            rule = {"running_mean": "zeros", "running_var": "ones",
                    "num_batches_tracked": "zeros"}.get(leaf)
            if rule is None:
                raise ValueError(f"no weight rule for the buffer {name}")
            plan.append((name, shape, t.dtype, rule, 0.0))
        elif t.dim() == 0:
            plan.append((name, shape, t.dtype, "ones", 0.0))
        elif t.dim() == 1:
            plan.append((name, shape, t.dtype, "centred" if leaf == "bias" else "one_centred",
                         BIAS))
        else:
            scale = math.sqrt(GAIN / _fan_in(owner[name], shape))
            if ".fc_1." in f".{name}":
                scale *= 0.5
            plan.append((name, shape, t.dtype, "centred", scale))
    return plan


def make_weights(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """{state-dict name: float32 tensor on `device`} for `model`, from `seed`."""
    plan = _plan(model)
    drawn = [p for p in plan if p[3] in ("centred", "one_centred")]
    total = sum(math.prod(p[1]) for p in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, pos = {}, 0
    for name, shape, dtype, rule, scale in plan:
        if rule in ("zeros", "ones"):
            fill = torch.zeros if rule == "zeros" else torch.ones
            out[name] = fill(shape, dtype=dtype if not dtype.is_floating_point else torch.float32,
                             device=device)
            continue
        n = math.prod(shape)
        w = flat[pos:pos + n].reshape(shape) * scale
        pos += n
        out[name] = w + 1.0 if rule == "one_centred" else w
    return out
