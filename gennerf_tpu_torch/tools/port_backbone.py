"""Backbone weights for the spatial encoder (the port's copy of the backbone
mode of scripts/port_weights.py; numpy and torch only).

    python -m gennerf_tpu_torch.tools.port_backbone random:resnet34 backbone.npz
    python -m gennerf_tpu_torch.tools.port_backbone resnet34.pth backbone.npz \\
        [--backbone resnet34] [--num-stages 3]

The checkpoint is a torchvision ResNet state dict (`.pth`, read with
`torch.load`; a Lightning checkpoint's `state_dict`, and the reference's
`encoder.model.` / `model.` prefixes, are unwrapped), or
`random:<backbone>`: a torchvision-shaped state dict of He-init weights
drawn from `default_rng(0)` in the JAX script's order, so both tools
write the same arrays. The output npz holds the stem and the first
`--num-stages` stages (num_layers - 1) as the flax tree rooted at the
ResNet: `params/...` (conv `kernel` (kh, kw, I, O), BatchNorm `scale` and
`bias`) and `batch_stats/...` (`mean`, `var`), blocks named
`layer{s}_{b}` with `down_conv`/`down_bn`. Either package grafts it at
init through `model.encoder.spatial.pretrained_path=<npz>` (here:
`predict.build_model` -> `graft_backbone`).
"""
from __future__ import annotations

import argparse
from typing import Dict, Tuple

import numpy as np
import torch

from ..models.resnet import RESNET_SPECS
from ..utils.port_params import flatten_params, load_params_npz, resnet_state_from_flax


def fabricate_resnet_state_dict(backbone: str, seed: int = 0) -> Dict[str, np.ndarray]:
    """A torchvision-shaped ResNet state dict with He-init random convs
    (BatchNorm scale 1, bias 0, running mean 0, variance 1), every conv
    drawn from one default_rng(seed) stream in torchvision's order."""
    rng = np.random.default_rng(seed)
    block_cls, layer_counts = RESNET_SPECS[backbone]
    bottleneck = block_cls.expansion == 4
    sd: Dict[str, np.ndarray] = {}

    def conv(name, co, ci, k):
        sd[name] = (rng.standard_normal((co, ci, k, k)) * np.sqrt(2.0 / (ci * k * k))
                    ).astype(np.float32)

    def bn(prefix, c):
        sd[prefix + ".weight"] = np.ones(c, np.float32)
        sd[prefix + ".bias"] = np.zeros(c, np.float32)
        sd[prefix + ".running_mean"] = np.zeros(c, np.float32)
        sd[prefix + ".running_var"] = np.ones(c, np.float32)

    conv("conv1.weight", 64, 3, 7)
    bn("bn1", 64)
    inplanes = 64
    for stage in range(4):
        planes = 64 * 2 ** stage
        for b in range(layer_counts[stage]):
            prefix = f"layer{stage + 1}.{b}"
            if bottleneck:
                conv(f"{prefix}.conv1.weight", planes, inplanes, 1)
                bn(f"{prefix}.bn1", planes)
                conv(f"{prefix}.conv2.weight", planes, planes, 3)
                bn(f"{prefix}.bn2", planes)
                conv(f"{prefix}.conv3.weight", planes * 4, planes, 1)
                bn(f"{prefix}.bn3", planes * 4)
                out = planes * 4
            else:
                conv(f"{prefix}.conv1.weight", planes, inplanes, 3)
                bn(f"{prefix}.bn1", planes)
                conv(f"{prefix}.conv2.weight", planes, planes, 3)
                bn(f"{prefix}.bn2", planes)
                out = planes
            # torchvision's downsample: the first block of a stage whose shape changes
            if b == 0 and (stage > 0 or inplanes != out):
                conv(f"{prefix}.downsample.0.weight", out, inplanes, 1)
                bn(f"{prefix}.downsample.1", out)
            inplanes = out
    return sd


def load_torchvision_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torchvision ResNet state dict from a .pth (or a Lightning checkpoint
    of a model holding one) as numpy arrays, reference prefixes removed."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    sd = {k: v.numpy() for k, v in obj.items() if isinstance(v, torch.Tensor)}
    for prefix in ("encoder.model.", "model."):
        if any(k.startswith(prefix + "conv1") for k in sd):
            return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return sd


def flax_resnet_from_torchvision(sd: Dict[str, np.ndarray], backbone: str,
                                 num_stages: int) -> Tuple[dict, dict]:
    """The stem and the first `num_stages` stages of a torchvision state
    dict as the flax ResNetStages (params, batch_stats) trees."""
    _, layer_counts = RESNET_SPECS[backbone]
    params: dict = {}
    stats: dict = {}

    def bn(dst_p, dst_s, name, prefix):
        dst_p[name] = {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}
        dst_s[name] = {"mean": sd[prefix + ".running_mean"], "var": sd[prefix + ".running_var"]}

    params["conv1"] = {"kernel": sd["conv1.weight"].transpose(2, 3, 1, 0)}
    bn(params, stats, "bn1", "bn1")
    for stage in range(num_stages):
        for b in range(layer_counts[stage]):
            prefix = f"layer{stage + 1}.{b}"
            block, block_stats = {}, {}
            ci = 1
            while f"{prefix}.conv{ci}.weight" in sd:
                kernel = sd[f"{prefix}.conv{ci}.weight"].transpose(2, 3, 1, 0)
                block[f"conv{ci}"] = {"kernel": kernel}
                bn(block, block_stats, f"bn{ci}", f"{prefix}.bn{ci}")
                ci += 1
            if f"{prefix}.downsample.0.weight" in sd:
                block["down_conv"] = {
                    "kernel": sd[f"{prefix}.downsample.0.weight"].transpose(2, 3, 1, 0)}
                bn(block, block_stats, "down_bn", f"{prefix}.downsample.1")
            params[f"layer{stage + 1}_{b}"] = block
            stats[f"layer{stage + 1}_{b}"] = block_stats
    return params, stats


def backbone_npz_arrays(checkpoint: str, backbone: str = "resnet34",
                        num_stages: int = 3) -> Dict[str, np.ndarray]:
    """The npz's '/'-joined arrays for `checkpoint` (a .pth or `random:<backbone>`)."""
    if checkpoint.startswith("random:"):
        backbone = checkpoint.split(":", 1)[1] or backbone
        sd = fabricate_resnet_state_dict(backbone)
    else:
        sd = load_torchvision_state_dict(checkpoint)
    params, stats = flax_resnet_from_torchvision(sd, backbone, num_stages)
    return {k: np.ascontiguousarray(v, np.float32)
            for k, v in flatten_params({"params": params, "batch_stats": stats}).items()}


@torch.no_grad()
def graft_backbone(model: torch.nn.Module, path: str) -> None:
    """Copy a backbone npz into `model.spatial.resnet`: every array must name
    a parameter or running statistic of the model's ResNet and match its
    shape (a KeyError or ValueError otherwise); the rest keep their init."""
    tree = load_params_npz(path)
    ported = resnet_state_from_flax(tree.get("params", {}), tree.get("batch_stats"))
    state = model.spatial.resnet.state_dict()
    for key, value in ported.items():
        if key not in state:
            raise KeyError(f"{path}: {key} is not in the model's ResNet")
        if tuple(state[key].shape) != value.shape:
            raise ValueError(f"{path}: shape mismatch at {key}: model "
                             f"{tuple(state[key].shape)} vs ported {value.shape}")
        state[key].copy_(torch.from_numpy(value))


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("checkpoint", help="torchvision .pth, or random:<backbone>")
    parser.add_argument("output", help="npz to write")
    parser.add_argument("--backbone", default="resnet34")
    parser.add_argument("--num-stages", type=int, default=3,
                        help="residual stages kept (num_layers - 1)")
    args = parser.parse_args(argv)
    flat = backbone_npz_arrays(args.checkpoint, args.backbone, args.num_stages)
    np.savez(args.output, **flat)
    n_values = sum(int(v.size) for v in flat.values())
    print(f"wrote {args.output}: {len(flat)} arrays, {n_values:,} values")
    return args.output


if __name__ == "__main__":
    main()
