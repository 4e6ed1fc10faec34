"""Plain PyTorch reference of a VoxelNet training step at the living-room
job's settings: the ResNet-50 stem and first three stages on every frame
(BatchNorm on each frame chunk's batch statistics, running statistics
moved once a chunk), the stage maps resized to the stem's size and
projected to the volume's channels, backprojected and averaged into the
voxel grid, the 3D encoder-decoder, the multi-scale TSDF heads with the
coarse-to-fine split, the log-L1 losses and Adam.

Float32 with TF32 off, written from the model's description and not from
the program: it imports nothing of gennerf_tpu_torch and reads the
benchmark's weights by the program's parameter names. Two rewrites keep
it inside one card's memory, both exact in real arithmetic: the 1x1
projection of the concatenated, resized stage maps is taken per stage
before the (linear) resize, and every residual block and frame chunk is
recomputed in backward (torch.utils.checkpoint), its running statistics
moved in the forward pass only.

`precision="fp8"` rounds every convolution's inputs to float8 e4m3 (the
control; see reference/gennerf_living.py).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .gennerf_living import Arith, adam_step, exact_float32, leaf_gaps  # noqa: F401

MOMENTUM, EPS = 0.9, 1e-5
BLOCKS = {"resnet50": (3, 4, 6, 3)}


class Net:
    """The weights W (leaves), the running statistics `stats` and the
    arithmetic; `update` says whether a BatchNorm moves its statistics."""

    def __init__(self, W: dict, stats: dict, a: Arith):
        self.W, self.stats, self.a = W, stats, a
        self.update = True

    def conv(self, x, pre, stride=1, padding=0, bias=False):
        w = self.W[pre + "weight"]
        b = self.W[pre + "bias"] if bias else None
        q = self.a.q
        conv = F.conv2d if w.dim() == 4 else F.conv3d
        return conv(q(x), q(w), b, stride=stride, padding=padding)

    def bn(self, x, pre):
        dims = (0,) + tuple(range(2, x.dim()))
        var, mean = torch.var_mean(x, dim=dims, unbiased=False)
        if self.update:
            for key, v in (("running_mean", mean), ("running_var", var)):
                self.stats[pre + key] = MOMENTUM * self.stats[pre + key] + (1 - MOMENTUM) * v.detach()
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return ((x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + EPS)
                * self.W[pre + "weight"].reshape(shape) + self.W[pre + "bias"].reshape(shape))


def remat(net: Net, fn, *args):
    """fn(*args) recomputed in backward; the statistics move on the first call only."""
    calls = []

    def run(*a):
        calls.append(None)
        keep = net.update
        net.update = keep and len(calls) == 1
        try:
            return fn(*a)
        finally:
            net.update = keep

    return checkpoint(run, *args, use_reentrant=False)


# -- the spatial encoder ---------------------------------------------------------

def bottleneck(net: Net, pre: str, x, stride: int):
    out = F.relu(net.bn(net.conv(x, pre + "conv1."), pre + "bn1."))
    out = F.relu(net.bn(net.conv(out, pre + "conv2.", stride, 1), pre + "bn2."))
    out = net.bn(net.conv(out, pre + "conv3."), pre + "bn3.")
    if pre + "downsample.0.weight" in net.W:
        x = net.bn(net.conv(x, pre + "downsample.0.", stride), pre + "downsample.1.")
    return F.relu(out + x)


def spatial_features(net: Net, cfg: dict, images: torch.Tensor) -> torch.Tensor:
    """(N, 3, H, W) images -> (N, out_channels, H', W') at the stem's size."""
    sp = cfg["model"]["encoder"]["spatial"]
    H, Wd = images.shape[-2:]
    s = float(sp["feature_scale"])
    x = F.interpolate(images, size=(int(H * s), int(Wd * s)), mode="bilinear",
                      align_corners=True) if s != 1.0 else images
    pre = "spatial.resnet."
    x = F.relu(net.bn(net.conv(x, pre + "conv1.", 2, 3), pre + "bn1."))
    maps = [x]
    for stage in range(sp["num_layers"] - 1):
        if stage == 0 and sp["use_first_pool"]:
            x = F.max_pool2d(x, 3, 2, 1)
        for b in range(BLOCKS[sp["backbone"]][stage]):
            stride = 2 if (stage > 0 and b == 0) else 1
            x = remat(net, bottleneck, net, f"{pre}layer{stage + 1}.{b}.", x, stride)
        maps.append(x)
    # proj(concat(resize(map_s))) = sum_s resize(proj_s(map_s)) + bias: both linear
    w = net.W["spatial.proj.weight"]
    size = maps[0].shape[-2:]
    out, c0 = 0, 0
    for m in maps:
        part = net.a.q(w[:, c0:c0 + m.shape[1]])
        y = F.conv2d(net.a.q(m), part)
        if tuple(y.shape[-2:]) != tuple(size):
            y = F.interpolate(y, size=size, mode="bilinear", align_corners=True)
        out = out + y
        c0 += m.shape[1]
    return out + net.W["spatial.proj.bias"].reshape(1, -1, 1, 1)


def backproject(feat: torch.Tensor, projection: torch.Tensor, image_hw, voxel_dim,
                voxel_size: float):
    """Sum over frames of each voxel's feature at the pixel its centre
    (i * voxel_size) rounds to, in front of the camera and inside the
    image: feat (B, t, C, h, w), projection (B, t, 3, 4) in image pixels,
    rescaled to the feature map's. The centres project in float32 (a pixel
    edge that float64 would place otherwise moves a few voxels' features
    to the neighbouring pixel). Returns (volume (B, C, nx, ny, nz), count
    (B, 1, nx, ny, nz))."""
    B, T, C, h, w = feat.shape
    H, Wd = image_hw
    dev = feat.device
    axes = [torch.arange(n, device=dev, dtype=torch.float32) * voxel_size for n in voxel_dim]
    world = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=0).reshape(3, -1)
    world = torch.cat([world, torch.ones_like(world[:1])])
    scale = torch.tensor([w / Wd, h / H, 1.0], dtype=torch.float32, device=dev).reshape(1, 3, 1)
    vol = torch.zeros(B, C, world.shape[1], device=dev)
    count = torch.zeros(B, 1, world.shape[1], device=dev)
    for t in range(T):
        cam = torch.einsum("bij,jv->biv", projection[:, t] * scale, world)
        z = cam[:, 2]
        zs = torch.where(z == 0, torch.full_like(z, 1e-8), z)
        px, py = torch.round(cam[:, 0] / zs).long(), torch.round(cam[:, 1] / zs).long()
        ok = (px >= 0) & (py >= 0) & (px < w) & (py < h) & (z > 0)
        idx = py.clamp(0, h - 1) * w + px.clamp(0, w - 1)
        cols = torch.gather(feat[:, t].reshape(B, C, h * w), 2, idx[:, None].expand(B, C, -1))
        vol = vol + torch.where(ok[:, None], cols, torch.zeros((), device=dev))
        count = count + ok[:, None].float()
    shape = (B, -1) + tuple(voxel_dim)
    return vol.reshape(shape), count.reshape(shape)


def encode(net: Net, cfg: dict, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The count-normalized feature volume (B, C, nx, ny, nz) at origin 0."""
    image, projection = batch["image"], batch["projection"]
    B, T = image.shape[:2]
    chunk = cfg["model"]["encoder"]["spatial"].get("frame_chunk") or T
    vd = tuple(int(n) for n in cfg["voxel_dim_train"])

    def fold(imgs, proj):
        t = proj.shape[1]
        f = spatial_features(net, cfg, imgs.reshape(B * t, *imgs.shape[2:]))
        return backproject(f.reshape(B, t, *f.shape[1:]), proj, image.shape[-2:], vd,
                           cfg["voxel_size"])

    vol = count = 0
    for t0 in range(0, T, chunk):
        v, c = remat(net, fold, image[:, t0:t0 + chunk], projection[:, t0:t0 + chunk])
        vol, count = vol + v, count + c
    return torch.where(count > 0, vol / count.clamp_min(1e-12), torch.zeros((), device=vol.device))


# -- the 3D encoder-decoder and the heads ------------------------------------------

def block3d(net: Net, pre: str, x):
    out = F.relu(net.bn(net.conv(x, pre + "conv1.", 1, 1), pre + "bn1."))
    out = net.bn(net.conv(out, pre + "conv2.", 1, 1), pre + "bn2.")
    return F.relu(out + x)


def backbone3d(net: Net, cfg: dict, x) -> List[torch.Tensor]:
    b3 = cfg["model"]["backbone3d"]
    ch, down, up = b3["channels"], b3["layers_down"], b3["layers"]
    pre = "backbone3d."
    xs = []
    for i in range(len(ch)):
        if i > 0:
            d = f"{pre}layers_down.{i}."
            x = F.relu(net.bn(net.conv(x, d + "0.", 2, 1), d + "1."))
        first = 0 if i == 0 else 4
        for k in range(down[i]):
            x = block3d(net, f"{pre}layers_down.{i}.{first + k}.", x)
        xs.append(x)
    xs = xs[::-1]
    out = []
    for i in range(len(ch) - 1):
        x = net.conv(F.interpolate(x, scale_factor=2, mode="trilinear", align_corners=False),
                     f"{pre}layers_up_conv.{i}.")
        y = F.relu(net.bn(net.conv(xs[i + 1], f"{pre}proj.{i}.conv."), f"{pre}proj.{i}.norm."))
        x = (x + y) / 2
        for k in range(up[i]):
            x = block3d(net, f"{pre}layers_up_res.{i}.{k}.", x)
        out.append(x)
    return out


def heads_loss(net: Net, cfg: dict, xs, batch) -> torch.Tensor:
    """Coarse to fine: tanh of a 1x1x1 convolution times label_smoothing; a
    finer scale keeps its value where the coarser one, upsampled, lies
    inside the sparse threshold and takes 0.999 times its sign elsewhere;
    per scale the masked mean log-L1 against the ground truth, summed."""
    h = cfg["model"]["heads"]["tsdf"]
    final = round(cfg["voxel_size"] * 100)
    sizes = [final * 2 ** i for i in range(len(xs))][::-1]
    total, prev, surface = 0, None, None
    for i, x in enumerate(xs):
        t = torch.tanh(net.conv(x, f"heads3d.heads.0.decoders.{i}.")) * h["label_smoothing"]
        mask = None
        if h["loss_split"] == "pred" and prev is not None:
            up = prev.repeat_interleave(2, 2).repeat_interleave(2, 3).repeat_interleave(2, 4)
            mask = up.abs() < h["sparse_threshold"][i - 1]
            t = torch.where(mask, t, torch.sign(up) * 0.999)
        trgt = batch["vol_%02d_tsdf" % sizes[i]]
        wanted = (trgt < 1) | (trgt == 1).all(dim=-1, keepdim=True)
        if mask is not None:
            wanted = wanted & mask
        p, g = t, trgt
        if h["loss_log_transform"]:
            s = h["loss_log_transform_shift"]
            p = torch.sign(p) * torch.log1p(p.abs() / s)
            g = torch.sign(g) * torch.log1p(g.abs() / s)
        loss = (p - g).abs() * h["loss_weight"]
        total = total + torch.where(wanted, loss, torch.zeros((), device=loss.device)).sum() \
            / wanted.sum()
        prev = t
    return total


def train_loss(net: Net, cfg: dict, batch) -> torch.Tensor:
    return heads_loss(net, cfg, backbone3d(net, cfg, encode(net, cfg, batch)), batch)


def train_steps(cfg: dict, W0: dict, steps: List[Tuple[dict, dict, Optional[torch.Tensor]]],
                precision: str = "float32"):
    """As reference/gennerf_living.train_steps; `change` also holds the
    BatchNorm running statistics' change over the steps."""
    exact_float32()
    a = Arith(precision)
    params = {k: v.detach().float().clone() for k, v in W0.items() if "running_" not in k}
    stats = {k: v.detach().float().clone() for k, v in W0.items() if "running_" in k}
    state: dict = {}
    losses, first = [], None
    for batch, _draws, _picked in steps:
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        net = Net(leaves, stats, a)
        loss = train_loss(net, cfg, batch)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                     allow_unused=True)))
        grads = {k: (g if g is not None else torch.zeros_like(params[k]))
                 for k, g in grads.items()}
        params = {k: v.detach() for k, v in params.items()}
        if first is None:
            first = {k: g + cfg["model"]["optimizer"]["weight_decay"] * params[k]
                     for k, g in grads.items()}
        adam_step(params, grads, state, cfg["model"]["optimizer"])
        losses.append(float(loss.detach()))
    change = {k: v - W0[k].float() for k, v in {**params, **stats}.items()}
    return losses, first, change, 0

