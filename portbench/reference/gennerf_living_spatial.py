"""Plain PyTorch reference of GenNerf with the combined encoder at the
living-room job's settings: the pointnet triplanes of
reference/gennerf_living.py beside a pixel-aligned feature volume. Each
frame goes through a Gaussian pre-blur (41 x 41, sigma 10, zero padding),
an align-corners bilinear resize by feature_scale, the ResNet stem and its
first num_layers - 1 stages of BasicBlocks (BatchNorm on its running
statistics: inference), every map resized (align-corners bilinear) to the
stem's size and concatenated; each voxel centre (i * voxel_size) reads the
feature of the pixel it rounds to in every frame that sees it, in front of
the camera and inside the image; the frames' sum over the count is the
voxel's mean feature, 0 where no frame saw it. The decoder samples the
planes bilinearly and the volume trilinearly (border, align corners) at
each grid point, and ResnetFC takes the two concatenated (planes first,
then the volume): d_in = c_dim + 512.

Float32 with TF32 off, written from the model's description and not from
the program: it imports nothing of gennerf_tpu_torch. Departures, each
exact in real arithmetic or a choice of what to compute:
- the TSDF is decoded only inside the fusion prior's near-surface band,
  the only voxels whose value is not the prior's +-1, and the volume's
  mean features only at the 8 neighbours of those grid points that the
  trilinear sample reads; so the judge never holds the 12.9 GB volume;
- every voxel centre is projected, in float32 as one (3, 4) x (4, V)
  product a frame, before the needed voxels are picked, so that a centre
  on a pixel edge rounds as a whole-grid projection rounds it;
- the blur is separable (a column pass, then a row pass), equal to the
  41 x 41 kernel, the outer product of the 1D ones.

`precision="fp8"` rounds every convolution's and product's inputs to
float8 e4m3 (the control; see reference/gennerf_living.py); the blur, the
resizes and the sampling are not products and stay float32.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .gennerf_living import (  # noqa: F401  (compare_volume, sparse_points: the driver's)
    Arith,
    compare_volume,
    dense_points,
    encode_planes,
    exact_float32,
    plane_coords,
    plane_frame,
    positional_code,
    prior_classes,
    resnet_block,
    sparse_points,
)

BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}
BN_EPS = 1e-5
PRE = "spatial.resnet."


# -- the 2D encoder --------------------------------------------------------------

def blur(images: torch.Tensor, kernel_size: int, sigma: float) -> torch.Tensor:
    """(N, C, H, W) -> the same, each channel convolved with the normalized
    Gaussian on the grid -k//2 .. k//2, zeros beyond the image."""
    half = kernel_size // 2
    x = torch.linspace(-half, half, kernel_size, device=images.device, dtype=torch.float32)
    g = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    g = g / g.sum()
    N, C, H, W = images.shape
    y = images.reshape(N * C, 1, H, W)
    y = F.conv2d(y, g.reshape(1, 1, kernel_size, 1), padding=(half, 0))
    y = F.conv2d(y, g.reshape(1, 1, 1, kernel_size), padding=(0, half))
    return y.reshape(N, C, H, W)


def resize(x: torch.Tensor, size) -> torch.Tensor:
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(int(s) for s in size), mode="bilinear",
                         align_corners=True)


def conv_bn(a: Arith, W: dict, x: torch.Tensor, conv: str, bn: str, stride: int,
            padding: int) -> torch.Tensor:
    """A bias-free convolution, then BatchNorm on its running statistics."""
    y = F.conv2d(a.q(x), a.q(W[conv + "weight"]), None, stride=stride, padding=padding)
    shape = (1, -1, 1, 1)
    mean, var = W[bn + "running_mean"].reshape(shape), W[bn + "running_var"].reshape(shape)
    return ((y - mean) * torch.rsqrt(var + BN_EPS) * W[bn + "weight"].reshape(shape)
            + W[bn + "bias"].reshape(shape))


def basic_block(a: Arith, W: dict, pre: str, x: torch.Tensor, stride: int) -> torch.Tensor:
    out = F.relu(conv_bn(a, W, x, pre + "conv1.", pre + "bn1.", stride, 1))
    out = conv_bn(a, W, out, pre + "conv2.", pre + "bn2.", 1, 1)
    if pre + "downsample.0.weight" in W:
        x = conv_bn(a, W, x, pre + "downsample.0.", pre + "downsample.1.", stride, 0)
    return F.relu(out + x)


def spatial_features(a: Arith, W: dict, cfg: dict, images: torch.Tensor) -> torch.Tensor:
    """(N, 3, H, W) images -> (N, 64 + 64 + 128 + ..., H', W') at the stem's size."""
    sp = cfg["model"]["encoder"]["spatial"]
    if sp["backbone"] not in BLOCKS:
        raise NotImplementedError(f"BasicBlock backbones only, not {sp['backbone']!r}")
    x = images.float()
    if sp["blur_image"]:
        x = blur(x, int(sp["kernel_size"]), float(sp["sigma"]))
    s = float(sp["feature_scale"])
    H, Wd = x.shape[-2:]
    if s > 1.0:
        x = resize(x, (int(H * s), int(Wd * s)))
    elif s < 1.0:
        f = int(round(1.0 / s))
        x = F.avg_pool2d(x, f, f)
    x = F.relu(conv_bn(a, W, x, PRE + "conv1.", PRE + "bn1.", 2, 3))
    maps = [x]
    for stage in range(sp["num_layers"] - 1):
        if stage == 0 and sp["use_first_pool"]:
            x = F.max_pool2d(x, 3, 2, 1)
        for b in range(BLOCKS[sp["backbone"]][stage]):
            stride = 2 if (stage > 0 and b == 0) else 1
            x = basic_block(a, W, f"{PRE}layer{stage + 1}.{b}.", x, stride)
        maps.append(x)
    size = maps[0].shape[-2:]
    return torch.cat([resize(m, size) for m in maps], dim=1)


# -- the feature volume at the voxels the decode reads ------------------------------

def trilinear_taps(xyz: torch.Tensor, voxel_dim, voxel_size: float):
    """(N, 3) world points on a volume of voxel_dim voxels at i * voxel_size:
    their 8 neighbours' flat indices (8, N) and the lerp fractions (3, N),
    border clamped. Order of the taps: (x, y, z) bits 000, 001, 010, ...,
    z the lowest."""
    n = torch.tensor(voxel_dim, dtype=torch.float32, device=xyz.device)
    g = ((2.0 * xyz / (n * voxel_size) - 1.0) + 1.0) * 0.5 * (n - 1)
    lo = torch.floor(g)
    frac = (g - lo).t()
    lo = lo.long()
    nx, ny, nz = (int(d) for d in voxel_dim)
    taps = []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                x = (lo[:, 0] + dx).clamp(0, nx - 1)
                y = (lo[:, 1] + dy).clamp(0, ny - 1)
                z = (lo[:, 2] + dz).clamp(0, nz - 1)
                taps.append((x * ny + y) * nz + z)
    return torch.stack(taps), frac


def lerp_taps(v: List[torch.Tensor], frac: torch.Tensor) -> torch.Tensor:
    """The trilinear value from the 8 taps' (N, C) values and (3, N) fractions."""
    wx, wy, wz = (f[:, None] for f in frac)
    c00 = v[0] * (1 - wz) + v[1] * wz
    c01 = v[2] * (1 - wz) + v[3] * wz
    c10 = v[4] * (1 - wz) + v[5] * wz
    c11 = v[6] * (1 - wz) + v[7] * wz
    return (c00 * (1 - wy) + c01 * wy) * (1 - wx) + (c10 * (1 - wy) + c11 * wy) * wx


def voxel_pixels(projection: torch.Tensor, voxel_dim, voxel_size: float, h: int, w: int,
                 image_hw):
    """Each voxel centre through one frame's (3, 4) world->image projection,
    rescaled to an (h, w) feature map: (flat pixel index, seen) (V,)."""
    dev = projection.device
    axes = [torch.arange(int(n), device=dev, dtype=torch.float32) * voxel_size
            for n in voxel_dim]
    world = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=0).reshape(3, -1)
    world = torch.cat([world, torch.ones_like(world[:1])])
    H, Wd = image_hw
    scale = torch.tensor([w / Wd, h / H, 1.0], dtype=torch.float32, device=dev).reshape(1, 3, 1)
    cam = torch.einsum("bij,jv->biv", projection[None].float() * scale, world)[0]
    z = cam[2]
    zs = torch.where(z == 0, torch.full_like(z, 1e-8), z)
    px, py = torch.round(cam[0] / zs).long(), torch.round(cam[1] / zs).long()
    seen = (px >= 0) & (py >= 0) & (px < w) & (py < h) & (z > 0)
    return py.clamp(0, h - 1) * w + px.clamp(0, w - 1), seen


def mean_features(feat: torch.Tensor, projection: torch.Tensor, image_hw, voxel_dim,
                  voxel_size: float, voxels: torch.Tensor, block: int = 1 << 18) -> torch.Tensor:
    """The volume's mean feature (len(voxels), C) at flat voxel indices:
    the frames' features summed in frame order, over the count of frames
    that see the voxel, 0 where none does. feat (T, C, h, w)."""
    T, C, h, w = feat.shape
    flat = feat.reshape(T, C, h * w)
    pix = [voxel_pixels(projection[t], voxel_dim, voxel_size, h, w, image_hw) for t in range(T)]
    out = []
    for part in torch.split(voxels, block):
        total = torch.zeros(C, part.numel(), device=feat.device)
        count = torch.zeros(part.numel(), device=feat.device)
        for t in range(T):
            idx, seen = pix[t][0][part], pix[t][1][part]
            total = total + torch.where(seen, flat[t][:, idx], torch.zeros((), device=feat.device))
            count = count + seen.float()
        out.append(torch.where(count > 0, total / count.clamp_min(1e-12),
                               torch.zeros((), device=feat.device)).t())
    return torch.cat(out)


# -- the decoder ---------------------------------------------------------------------

def decode(a: Arith, W: dict, cfg: dict, planes: Dict[str, torch.Tensor], vol_feat: torch.Tensor,
           xyz: torch.Tensor) -> torch.Tensor:
    """TSDF (N,) at (N, 3) world points from the planes and the volume's
    trilinear samples there, vol_feat (N, C)."""
    m = cfg["model"]
    pn = m["encoder"]["pointnet"]
    p = plane_frame(xyz, cfg)[None]
    feat = 0
    for pl, plane in planes.items():
        grid = plane_coords(p, pl, pn["padding"]) * 2.0 - 1.0
        s = F.grid_sample(plane, grid[:, :, None, :], mode="bilinear", padding_mode="border",
                          align_corners=True)
        feat = feat + s[0, :, :, 0].t()
    feat = torch.cat([feat, vol_feat], dim=-1)
    code = m["code"]
    z = positional_code(xyz, code["num_freqs"], code["freq_factor"], code["include_input"])
    x = a.linear(feat, W["mlp.lin_in.weight"], W["mlp.lin_in.bias"])
    for b in range(m["mlp"]["n_blocks"]):
        x = x + W["mlp.alpha"] * a.linear(z, W[f"mlp.lin_z.{b}.weight"], W[f"mlp.lin_z.{b}.bias"])
        x = resnet_block(a, W, f"mlp.blocks.{b}.", x)
    d_geo = m["mlp"]["d_out_geo"]
    geo = a.linear(torch.relu(x), W["mlp.lin_out.weight"], W["mlp.lin_out.bias"])[..., :d_geo]
    return torch.tanh(a.linear(geo, W["head_geo.fc.weight"], W["head_geo.fc.bias"]))[..., 0]


# -- reconstruction --------------------------------------------------------------

@torch.no_grad()
def reconstruct(cfg: dict, W: dict, scene: Dict[str, torch.Tensor], sel: torch.Tensor,
                start: torch.Tensor, picked: Optional[torch.Tensor], precision: str = "float32",
                chunk: int = 1 << 16):
    """The reference's volume of one scene at voxel_dim_test, with the fusion
    prior: the decoded TSDF in the band, the prior's +-1 elsewhere. Returns
    (volume (nx, ny, nz), near, ambiguous (V,) bools, bad picks)."""
    exact_float32()
    a = Arith(precision)
    W = {k: v.float() for k, v in W.items()}
    voxel_dim = tuple(int(n) for n in cfg["voxel_dim_test"])
    vs = float(cfg["voxel_size"])
    image, depth, projection = scene["image"], scene["depth"], scene["projection"]
    pts, bad = sparse_points(cfg, depth, projection, sel, start, picked)
    planes = encode_planes(a, W, cfg, pts.reshape(1, -1, 3))
    near, far, amb = prior_classes(voxel_dim, vs, projection, depth, 3 * vs)
    band = torch.nonzero(near)[:, 0]
    xyz = dense_points(voxel_dim, vs, depth.device)[band]
    taps, frac = trilinear_taps(xyz, voxel_dim, vs)
    voxels, inverse = torch.unique(taps.reshape(-1), return_inverse=True)
    feat = spatial_features(a, W, cfg, image)
    table = mean_features(feat, projection, image.shape[-2:], voxel_dim, vs, voxels)
    del feat
    inverse = inverse.reshape(taps.shape)
    tsdf = torch.empty(band.numel(), device=depth.device)
    for lo in range(0, band.numel(), chunk):
        hi = min(lo + chunk, band.numel())
        sample = lerp_taps([table[inverse[k, lo:hi]] for k in range(8)], frac[:, lo:hi])
        tsdf[lo:hi] = decode(a, W, cfg, planes, sample, xyz[lo:hi])
    one = torch.ones((), device=depth.device)
    vol = torch.where(far, -one, one)
    vol[band] = tsdf
    return vol.reshape(voxel_dim), near, amb, bad

