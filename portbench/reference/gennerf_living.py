"""Plain PyTorch reference of GenNerf at the living-room job's settings:
pointnet triplanes (presample, farthest points, a local-pooling PointNet,
one UNet over the three planes), ResnetFC with the positional code and the
TSDF head, the fusion prior of inference, the ray supervision, the
smooth-log L1 loss and Adam with coupled weight decay.

Float32 with TF32 off, written from the model's description and not from
the program: it imports nothing of gennerf_tpu_torch. It reads the
benchmark's weights by the program's parameter names, and the program's
outputs only to judge them: the farthest-point picks are the program's
(a selection whose ties rounding decides), checked here to be farthest
points of the reference's own cloud before the reference goes on with its
own coordinates of them.

`precision="fp8"` rounds every product's inputs to float8 e4m3 (per-tensor
scale to its largest value, gradients passed straight through): the
control, the reference computed one step below the configuration's bf16.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

PLANES = {"xz": (0, 2), "xy": (0, 1), "yz": (1, 2)}
FP8_MAX = 448.0


def exact_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


class Arith:
    """Products in float32, or with inputs rounded to fp8 (the control)."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(precision)
        self.fp8 = precision == "fp8"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _RoundFp8.apply(x) if self.fp8 else x

    def linear(self, x, w, b=None):
        y = self.q(x) @ self.q(w).t()
        return y if b is None else y + b

    def conv2d(self, x, w, b, padding=0):
        return F.conv2d(self.q(x), self.q(w), b, padding=padding)

    def conv_transpose2d(self, x, w, b, stride):
        return F.conv_transpose2d(self.q(x), self.q(w), b, stride=stride)


# -- geometry ----------------------------------------------------------------

def unproject(depth: torch.Tensor, projection: torch.Tensor) -> torch.Tensor:
    """(F, H, W) depths through (F, 3, 4) world->pixel projections -> (F,
    H*W, 3) float32 world points, in float64 (a zero depth gives the camera
    centre)."""
    Fn, H, W = depth.shape
    P = torch.cat([projection.double(), torch.tensor([[[0.0, 0.0, 0.0, 1.0]]], dtype=torch.float64,
                                                     device=depth.device).expand(Fn, 1, 4)], 1)
    inv = torch.linalg.inv(P)
    v, u = torch.meshgrid(torch.arange(H, device=depth.device, dtype=torch.float64),
                          torch.arange(W, device=depth.device, dtype=torch.float64), indexing="ij")
    d = depth.double()
    pix = torch.stack([u * d, v * d, d, torch.ones_like(d)], dim=-1).reshape(Fn, H * W, 4)
    world = torch.einsum("fij,fpj->fpi", inv, pix)
    return (world[..., :3] / world[..., 3:]).float()


def plane_frame(xyz: torch.Tensor, cfg: dict) -> torch.Tensor:
    """World points in the planes' frame: with normalize_coords the training
    volume's box onto the cube of side 1 around 0."""
    m = cfg["model"]
    if not m["encoder"]["pointnet"].get("normalize_coords", False):
        return xyz
    extent = torch.tensor(cfg["voxel_dim_train"], dtype=torch.float32,
                          device=xyz.device) * cfg["voxel_size"]
    return (xyz - extent / 2) / extent.max()


def fps_plain(cloud: torch.Tensor, npoint: int, start: torch.Tensor) -> torch.Tensor:
    """Farthest points of (F, N, 3) clouds from (F,) starts, distances in
    float64 -> (F, npoint) indices."""
    pts = cloud.double()
    rows = torch.arange(pts.shape[0], device=pts.device)
    dist = torch.full(pts.shape[:2], float("inf"), dtype=torch.float64, device=pts.device)
    idx = torch.empty(pts.shape[0], npoint, dtype=torch.int64, device=pts.device)
    far = start.long()
    for i in range(npoint):
        idx[:, i] = far
        dist = torch.minimum(dist, ((pts - pts[rows, far][:, None]) ** 2).sum(-1))
        far = dist.argmax(dim=1)
    return idx


def judge_fps(picked: torch.Tensor, cloud: torch.Tensor, start: torch.Tensor,
              rel_tol: float = 1e-4, match_tol: float = 1e-4) -> Tuple[torch.Tensor, int]:
    """The program's picks, (F, n, 3) points in the planes' frame, against
    the reference's presampled clouds `cloud` (F, N, 3), in the same frame:
    each pick is matched to its cloud point, and pick k must be (up to
    `rel_tol` of the distance, a tie that rounding may break either way) a
    farthest point from picks 0..k-1, pick 0 the start point. Returns (the
    matched indices (F, n), the number of picks that are not)."""
    Fn, n, _ = picked.shape
    idx = torch.empty(Fn, n, dtype=torch.int64, device=cloud.device)
    bad = 0
    for f in range(Fn):
        d = torch.cdist(picked[f].double(), cloud[f].double())
        best, arg = d.min(dim=1)
        idx[f] = arg
        bad += int((best > match_tol).sum())
    pts = cloud.double()
    rows = torch.arange(Fn, device=cloud.device)
    first = pts[rows, idx[:, 0]]
    bad += int(((first - pts[rows, start.long()]).abs().amax(-1) > 0).sum())
    dist = torch.full(pts.shape[:2], float("inf"), dtype=torch.float64, device=pts.device)
    for k in range(1, n):
        dist = torch.minimum(dist, ((pts - pts[rows, idx[:, k - 1]][:, None]) ** 2).sum(-1))
        got = dist[rows, idx[:, k]]
        bad += int((got < dist.amax(dim=1) * (1 - rel_tol)).sum())
    return idx, bad


# -- the encoder ---------------------------------------------------------------

def plane_index(p: torch.Tensor, plane: str, padding: float, reso: int) -> torch.Tensor:
    xy = p[..., list(PLANES[plane])] / (1.0 + padding + 1e-5) + 0.5
    xy = xy.clamp(0.0, 1.0 - 1e-5)
    cell = (xy * reso).long()
    return cell[..., 0] + reso * cell[..., 1]


def plane_coords(p: torch.Tensor, plane: str, padding: float) -> torch.Tensor:
    xy = p[..., list(PLANES[plane])] / (1.0 + padding + 1e-5) + 0.5
    return xy.clamp(0.0, 1.0 - 1e-5)


def resnet_block(a: Arith, W: dict, pre: str, x: torch.Tensor) -> torch.Tensor:
    net = a.linear(torch.relu(x), W[pre + "fc_0.weight"], W[pre + "fc_0.bias"])
    dx = a.linear(torch.relu(net), W[pre + "fc_1.weight"], W[pre + "fc_1.bias"])
    short = W.get(pre + "shortcut.weight")
    return (x if short is None else a.linear(x, short)) + dx


def segment_reduce(x: torch.Tensor, index: torch.Tensor, cells: int, how: str) -> torch.Tensor:
    """(B, N, C) point values onto (B, cells, C): max or mean, empty cells 0."""
    B, N, C = x.shape
    ix = index[..., None].expand(B, N, C)
    zeros = torch.zeros(B, cells, C, dtype=x.dtype, device=x.device)
    if how == "max":
        return zeros.scatter_reduce(1, ix, x, "amax", include_self=False)
    total = zeros.scatter_add(1, ix, x)
    count = torch.zeros(B, cells, dtype=x.dtype, device=x.device).scatter_add(
        1, index, torch.ones_like(index, dtype=x.dtype))
    return total / count.clamp_min(1.0)[..., None]


def unet(a: Arith, W: dict, x: torch.Tensor, depth: int) -> torch.Tensor:
    pre = "pointnet.unet."
    skips = []
    for i in range(depth):
        d = f"{pre}down_convs.{i}."
        x = torch.relu(a.conv2d(x, W[d + "conv1.weight"], W[d + "conv1.bias"], 1))
        x = torch.relu(a.conv2d(x, W[d + "conv2.weight"], W[d + "conv2.bias"], 1))
        skips.append(x)
        if i < depth - 1:
            x = F.max_pool2d(x, 2, 2)
    for i in range(depth - 1):
        u = f"{pre}up_convs.{i}."
        up = a.conv_transpose2d(x, W[u + "upconv.weight"], W[u + "upconv.bias"], 2)
        x = torch.cat([up, skips[-(i + 2)]], dim=1)
        x = torch.relu(a.conv2d(x, W[u + "conv1.weight"], W[u + "conv1.bias"], 1))
        x = torch.relu(a.conv2d(x, W[u + "conv2.weight"], W[u + "conv2.bias"], 1))
    return a.conv2d(x, W[pre + "conv_final.weight"], W[pre + "conv_final.bias"])


def encode_planes(a: Arith, W: dict, cfg: dict, p: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(B, n, 3) sparse points in the planes' frame -> plane -> (B, c_dim, reso, reso)."""
    pn = cfg["model"]["encoder"]["pointnet"]
    reso, padding = pn["plane_resolution"], pn["padding"]
    planes = list(pn["plane_type"])
    index = {pl: plane_index(p, pl, padding, reso) for pl in planes}
    net = a.linear(p, W["pointnet.fc_pos.weight"], W["pointnet.fc_pos.bias"])
    net = resnet_block(a, W, "pointnet.blocks.0.", net)
    for i in range(1, pn["n_blocks"]):
        pooled = 0
        for pl in planes:
            cellmax = segment_reduce(net, index[pl], reso * reso, pn["scatter_type"])
            pooled = pooled + torch.gather(cellmax, 1, index[pl][..., None].expand_as(net))
        net = resnet_block(a, W, f"pointnet.blocks.{i}.", torch.cat([net, pooled], dim=-1))
    c = a.linear(net, W["pointnet.fc_c.weight"], W["pointnet.fc_c.bias"])
    B, _, C = c.shape
    flat = [segment_reduce(c, index[pl], reso * reso, "mean").reshape(B, reso, reso, C)
            .permute(0, 3, 1, 2) for pl in planes]
    smooth = unet(a, W, torch.cat(flat, dim=0), pn["unet_kwargs"]["depth"])
    return {pl: smooth[i * B:(i + 1) * B] for i, pl in enumerate(planes)}


# -- the decoder ---------------------------------------------------------------

def positional_code(x: torch.Tensor, num_freqs: int, freq_factor: float,
                    include_input: bool) -> torch.Tensor:
    parts = [x] if include_input else []
    for k in range(num_freqs):
        f = freq_factor * 2.0 ** k
        parts += [torch.sin(f * x), torch.cos(f * x)]
    return torch.cat(parts, dim=-1)


def decode(a: Arith, W: dict, cfg: dict, planes: Dict[str, torch.Tensor],
           xyz: torch.Tensor) -> torch.Tensor:
    """TSDF (B, N) at (B, N, 3) world points."""
    m = cfg["model"]
    pn = m["encoder"]["pointnet"]
    p = plane_frame(xyz, cfg)
    feat = 0
    for pl, plane in planes.items():
        grid = plane_coords(p, pl, pn["padding"]) * 2.0 - 1.0
        s = F.grid_sample(plane, grid[:, :, None, :], mode="bilinear", padding_mode="border",
                          align_corners=True)
        feat = feat + s[..., 0].permute(0, 2, 1)
    code = m["code"]
    z = positional_code(xyz, code["num_freqs"], code["freq_factor"], code["include_input"])
    x = a.linear(feat, W["mlp.lin_in.weight"], W["mlp.lin_in.bias"])
    for b in range(m["mlp"]["n_blocks"]):
        x = x + W["mlp.alpha"] * a.linear(z, W[f"mlp.lin_z.{b}.weight"], W[f"mlp.lin_z.{b}.bias"])
        x = resnet_block(a, W, f"mlp.blocks.{b}.", x)
    d_geo = m["mlp"]["d_out_geo"]
    geo = a.linear(torch.relu(x), W["mlp.lin_out.weight"], W["mlp.lin_out.bias"])[..., :d_geo]
    return torch.tanh(a.linear(geo, W["head_geo.fc.weight"], W["head_geo.fc.bias"]))[..., 0]


def sparse_points(cfg: dict, depth: torch.Tensor, projection: torch.Tensor, sel: torch.Tensor,
                  start: torch.Tensor, picked: Optional[torch.Tensor]):
    """The encoder's sparse points of (F, H, W) frames in the planes' frame,
    (F, n, 3): the program's picks judged (`picked` (F, n, 3)), or the
    reference's own farthest points when none are given. Returns (points,
    bad picks)."""
    pn = cfg["model"]["encoder"]["pointnet"]
    cloud = torch.gather(unproject(depth, projection), 1, sel.long()[..., None].expand(-1, -1, 3))
    cloud = plane_frame(cloud, cfg)
    if picked is None:
        idx, bad = fps_plain(cloud, pn["num_sparse_points"], start), 0
    else:
        idx, bad = judge_fps(picked.reshape(cloud.shape[0], -1, 3), cloud, start)
    return torch.gather(cloud, 1, idx[..., None].expand(-1, -1, 3)), bad


# -- reconstruction --------------------------------------------------------------

def dense_points(voxel_dim, voxel_size: float, device) -> torch.Tensor:
    """(nx*ny*nz, 3) decode grid: per axis n points from 0 to n * voxel_size."""
    axes = [torch.linspace(0.0, voxel_size * n, n, device=device) for n in voxel_dim]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 3)


def prior_classes(voxel_dim, voxel_size: float, projection: torch.Tensor, depth: torch.Tensor,
                  trunc: float, pix_eps: float = 2e-3, len_eps: float = 1e-5):
    """Fusion prior of (T, 3, 4) projections and (T, H, W) depths over the
    voxels at i * voxel_size, in float64: (near, farfront, ambiguous) (V,)
    bools. A frame sees a voxel where its centre rounds to a pixel of the
    image in front of the camera with a depth; near: |z - d| < trunc;
    farfront: z - d <= -trunc. A voxel is ambiguous where a frame's pixel
    lies within pix_eps of a rounding edge and the other pixel would class
    it otherwise, or z - d within len_eps of a class edge."""
    T, H, W = depth.shape
    device = depth.device
    nx, ny, nz = voxel_dim
    axes = [torch.arange(n, device=device, dtype=torch.float64) * voxel_size for n in voxel_dim]
    world = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 3)
    V = world.shape[0]
    near = torch.zeros(V, dtype=torch.bool, device=device)
    far = torch.zeros_like(near)
    amb = torch.zeros_like(near)
    for t in range(T):
        P = projection[t].double()
        cam = world @ P[:, :3].t() + P[:, 3]
        z = cam[:, 2]
        zs = torch.where(z == 0, torch.full_like(z, 1e-8), z)
        fx, fy = cam[:, 0] / zs, cam[:, 1] / zs

        def classes(px, py):
            inside = (px >= 0) & (py >= 0) & (px < W) & (py < H) & (z > 0)
            d = depth[t][py.clamp(0, H - 1), px.clamp(0, W - 1)].double()
            seen = inside & (d > 0)
            return seen & ((z - d).abs() < trunc), seen & ((z - d) <= -trunc), d, seen

        px, py = torch.round(fx).long(), torch.round(fy).long()
        n0, f0, d0, seen = classes(px, py)
        near |= n0
        far |= f0
        alt_x = torch.where(fx - torch.floor(fx) >= 0.5, torch.floor(fx), torch.floor(fx) + 1).long()
        alt_y = torch.where(fy - torch.floor(fy) >= 0.5, torch.floor(fy), torch.floor(fy) + 1).long()
        edge_x = ((fx - torch.floor(fx)) - 0.5).abs() < pix_eps
        edge_y = ((fy - torch.floor(fy)) - 0.5).abs() < pix_eps
        for ax, ay, on in ((alt_x, py, edge_x), (px, alt_y, edge_y), (alt_x, alt_y, edge_x & edge_y)):
            n1, f1, _, _ = classes(ax, ay)
            amb |= on & ((n1 != n0) | (f1 != f0))
        gap = z - d0
        amb |= seen & (((gap.abs() - trunc).abs() < len_eps) | ((gap + trunc).abs() < len_eps))
    return near, far, amb


@torch.no_grad()
def reconstruct(cfg: dict, W: dict, scene: Dict[str, torch.Tensor], sel: torch.Tensor,
                start: torch.Tensor, picked: Optional[torch.Tensor], precision: str = "float32",
                chunk: int = 1 << 18):
    """The reference's volume of one scene at voxel_dim_test, with the fusion
    prior. Returns (volume (nx, ny, nz), near, ambiguous (V,) bools, bad picks)."""
    exact_float32()
    a = Arith(precision)
    W = {k: v.float() for k, v in W.items()}
    voxel_dim = tuple(int(n) for n in cfg["voxel_dim_test"])
    vs = float(cfg["voxel_size"])
    pts, bad = sparse_points(cfg, scene["depth"], scene["projection"], sel, start, picked)
    planes = encode_planes(a, W, cfg, pts.reshape(1, -1, 3))
    grid = dense_points(voxel_dim, vs, scene["depth"].device)
    tsdf = torch.cat([decode(a, W, cfg, planes, c[None])[0] for c in torch.split(grid, chunk)])
    near, far, amb = prior_classes(voxel_dim, vs, scene["projection"], scene["depth"], 3 * vs)
    one = torch.ones((), device=tsdf.device)
    vol = torch.where(near, tsdf, torch.where(far, -one, one))
    return vol.reshape(voxel_dim), near, amb, bad


def compare_volume(program: torch.Tensor, ref: torch.Tensor, near: torch.Tensor,
                   amb: torch.Tensor) -> Dict[str, float]:
    """Over the voxels that are not ambiguous: band_logit_rel_rms_gap, the
    gap inside the reference's near-surface band carried back through the
    head's tanh, (p - r) / (1 - r^2), its RMS over that of atanh(r), where
    the reference is off saturation (|r| < 0.99); prior_mismatches, the
    voxels outside the band whose value is not the reference's +-1
    exactly. The tanh's saturation, which the seed's weights set anywhere
    from 3% to 80% of the band, scales a gap taken after it
    (band_rel_rms_gap, kept as information) by as much."""
    p, r = program.reshape(-1).to(ref.device).float(), ref.reshape(-1)
    band = near & ~amb
    pb, rb = p[band].double(), r[band].double()
    rel = math.sqrt(float(((pb - rb) ** 2).mean())) / max(math.sqrt(float((rb ** 2).mean())), 1e-12)
    live = rb.abs() < 0.99
    dz = (pb[live] - rb[live]) / (1 - rb[live] ** 2)
    logit = math.sqrt(float((dz ** 2).mean())) / max(
        math.sqrt(float((torch.atanh(rb[live]) ** 2).mean())), 1e-12)
    outside = ~near & ~amb
    return {"band_logit_rel_rms_gap": logit, "band_rel_rms_gap": rel,
            "prior_mismatches": float((p[outside] != r[outside]).sum()),
            "ambiguous_share": float(amb.double().mean()),
            "band_share": float(near.double().mean()),
            "band_saturated_share": float(1 - live.double().mean())}


# -- training ------------------------------------------------------------------

def ray_points(cfg: dict, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor]):
    """The ray supervision of every frame: (BT, R*S, 3) world points and
    their (BT, R*S) validity. Pixels: the num_rays top uniform scores among
    those with depth; samples: the surface, N points evenly from d_min to
    depth + delta, M at depth + sigma * noise."""
    ray = cfg["model"]["ray"]
    depth = batch["depth"]
    B, T, H, Wd = depth.shape
    BT = B * T
    d = depth.reshape(BT, H * Wd)
    scores = torch.where(d != 0, draws["scores"].float(), torch.full_like(d, float("-inf")))
    pick = torch.topk(scores, ray["num_rays"], dim=1).indices
    ok = torch.gather(d != 0, 1, pick)
    sd = torch.gather(d, 1, pick)
    h, w = (pick // Wd).float(), (pick % Wd).float()
    N, M = ray["N"], ray["M"]
    frac = torch.arange(N, device=d.device, dtype=torch.float32) / (N - 1)
    strat = ray["d_min"] + frac * (sd[..., None] + ray["delta"] - ray["d_min"])
    z = torch.cat([sd[..., None], strat, sd[..., None] + ray["sigma"] * draws["noise"].float()], -1)
    K = batch["intrinsics"].reshape(BT, 3, 3)
    xn = (w - K[:, 0, 2, None]) / K[:, 0, 0, None]
    yn = (h - K[:, 1, 2, None]) / K[:, 1, 1, None]
    cam = torch.stack([xn[..., None] * z, yn[..., None] * z, z], dim=-1)
    pose = batch["pose"].reshape(BT, 4, 4)
    world = torch.einsum("bij,brsj->brsi", pose[:, :3, :3], cam) + pose[:, None, None, :3, 3]
    S = z.shape[-1]
    valid = ok[..., None].expand(BT, ray["num_rays"], S)
    return world.reshape(BT, -1, 3), valid.reshape(BT, -1).float()


def gt_at(vol: torch.Tensor, xyz: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """(B, 1, nx, ny, nz) ground truth at (B, N, 3) world points: trilinear,
    the volume's n samples spread over [0, n * voxel_size], border clamped."""
    nx, ny, nz = vol.shape[2:]
    ext = torch.tensor([nx, ny, nz], device=xyz.device, dtype=torch.float32) * voxel_size
    g = 2.0 * xyz / ext - 1.0
    s = F.grid_sample(vol, g.flip(-1)[:, :, None, None, :], mode="bilinear",
                      padding_mode="border", align_corners=True)
    return s.reshape(vol.shape[0], -1)


def smooth_log(x: torch.Tensor, shift: float, beta: float) -> torch.Tensor:
    return torch.tanh(x) * F.softplus(beta * x.abs() / shift, beta=1.0, threshold=1e9) / beta


def train_loss(a: Arith, W: dict, cfg: dict, batch: Dict[str, torch.Tensor],
               draws: Dict[str, torch.Tensor], pts: torch.Tensor) -> torch.Tensor:
    """One batch's loss: the valid samples' mean smooth-log L1, times T."""
    B, T = batch["depth"].shape[:2]
    planes = encode_planes(a, W, cfg, pts.reshape(B, -1, 3))
    xyz, valid = ray_points(cfg, batch, draws)
    xyz = xyz.reshape(B, -1, 3)
    pred = decode(a, W, cfg, planes, xyz)
    vs = float(cfg["voxel_size"])
    target = gt_at(batch["vol_%02d_tsdf" % round(vs * 100)], xyz, vs)
    t = cfg["model"]["loss"]["tsdf"]
    err = (smooth_log(pred, t["shift"], t["smoothness"])
           - smooth_log(target, t["shift"], t["smoothness"])).abs()
    valid = valid.reshape(B, -1)
    return t["weight"] * (err * valid).sum() / valid.sum() * T


def adam_step(W: dict, grads: dict, state: dict, opt: dict) -> None:
    """Adam with coupled weight decay (the gradient plus wd * w), betas
    0.9 / 0.999, eps 1e-8, in place on W; state holds step, m and v."""
    b1, b2, eps, lr, wd = 0.9, 0.999, 1e-8, opt["lr"], opt["weight_decay"]
    state["step"] = state.get("step", 0) + 1
    t = state["step"]
    for k, g in grads.items():
        g = g + wd * W[k]
        m = state.setdefault("m", {}).get(k, torch.zeros_like(g)) * b1 + (1 - b1) * g
        v = state.setdefault("v", {}).get(k, torch.zeros_like(g)) * b2 + (1 - b2) * g * g
        state["m"][k], state["v"][k] = m, v
        W[k] = W[k] - lr * (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + eps)


def train_steps(cfg: dict, W0: dict, steps: List[Tuple[dict, dict, Optional[torch.Tensor]]],
                precision: str = "float32"):
    """The reference's first steps from weights W0, each (batch, draws,
    program's picks or None). Returns (losses, first gradient as Adam takes
    it (with the decay term), change of each parameter over the steps, bad
    picks)."""
    exact_float32()
    a = Arith(precision)
    W = {k: v.detach().float().clone() for k, v in W0.items()}
    state: dict = {}
    losses, first, bad = [], None, 0
    for batch, draws, picked in steps:
        B, T, H, Wd = batch["depth"].shape
        pts, b = sparse_points(cfg, batch["depth"].reshape(B * T, H, Wd),
                               batch["projection"].reshape(B * T, 3, 4), draws["sel"],
                               draws["start"], picked)
        bad += b
        leaves = {k: v.requires_grad_(True) for k, v in W.items()}
        loss = train_loss(a, leaves, cfg, batch, draws, pts)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                     allow_unused=True)))
        grads = {k: (g if g is not None else torch.zeros_like(W[k])) for k, g in grads.items()}
        W = {k: v.detach() for k, v in W.items()}
        if first is None:
            first = {k: g + cfg["model"]["optimizer"]["weight_decay"] * W[k]
                     for k, g in grads.items()}
        adam_step(W, grads, state, cfg["model"]["optimizer"])
        losses.append(float(loss.detach()))
    change = {k: W[k] - W0[k].float() for k in W}
    return losses, first, change, bad


def leaf_gaps(program: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              ref_grad: Dict[str, torch.Tensor], skip_below: float = 1e-3) -> dict:
    """Each leaf's gap of norms, | |program| - |ref| | over the larger of the
    reference leaf's norm and the median leaf's, over the leaves whose
    reference gradient is at least skip_below times the median leaf's (the
    others move by round-off alone). Returns {worst, leaf (the worst one),
    median, left_out}."""
    gnorm = {k: float(v.double().norm()) for k, v in ref_grad.items()}
    gmed = sorted(gnorm.values())[len(gnorm) // 2]
    keep = [k for k in ref if gnorm[k] >= skip_below * gmed]
    norms = {k: float(ref[k].double().norm()) for k in keep}
    med = sorted(norms.values())[len(norms) // 2]
    gaps = {k: abs(float(program[k].double().norm()) - norms[k]) / max(norms[k], med, 1e-30)
            for k in keep}
    leaf = max(gaps, key=gaps.get)
    return {"worst": gaps[leaf], "leaf": leaf, "median": sorted(gaps.values())[len(gaps) // 2],
            "left_out": sorted(set(ref) - set(keep))}
