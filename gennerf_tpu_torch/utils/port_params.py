"""JAX/flax GenNerf parameters -> the port's state_dict.

The input is the flax `params` tree as nested dicts of numpy arrays (no
JAX needed to read it). Dense kernels (in, out) transpose to torch's
(out, in); Conv kernels (kh, kw, I, O) become (O, I, kh, kw); flax's
ConvTranspose kernel is the spatial flip of torch's ConvTranspose2d
weight (I, O, kh, kw). ResnetFC's `alpha` and the TSDF head carry over.
Reading orbax checkpoints is left to the JAX side: save `params` to an
npz with `save_params_npz` there, load it here with `load_params_npz`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _dense(out: Dict, prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = np.asarray(p["kernel"], np.float32).T
    if "bias" in p:
        out[prefix + ".bias"] = np.asarray(p["bias"], np.float32)


def _conv(out: Dict, prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1)
    out[prefix + ".bias"] = np.asarray(p["bias"], np.float32)


def _conv_transpose(out: Dict, prefix: str, p: dict) -> None:
    k = np.asarray(p["kernel"], np.float32)[::-1, ::-1]
    out[prefix + ".weight"] = k.transpose(2, 3, 0, 1)
    out[prefix + ".bias"] = np.asarray(p["bias"], np.float32)


def _block(out: Dict, prefix: str, p: dict) -> None:
    _dense(out, prefix + ".fc_0", p["Dense_0"])
    _dense(out, prefix + ".fc_1", p["Dense_1"])
    if "Dense_2" in p:
        _dense(out, prefix + ".shortcut", p["Dense_2"])


def gen_nerf_params_from_flax(tree: dict) -> Dict[str, torch.Tensor]:
    """flax GenNerf `params` (nested dicts of arrays) -> GenNerf state_dict."""
    out: Dict[str, np.ndarray] = {}
    pn = tree["pointnet"]
    _dense(out, "pointnet.fc_pos", pn["fc_pos"])
    _dense(out, "pointnet.fc_c", pn["fc_c"])
    i = 0
    while f"block_{i}" in pn:
        _block(out, f"pointnet.blocks.{i}", pn[f"block_{i}"])
        i += 1
    if "unet" in pn:
        un = pn["unet"]
        i = 0
        while f"down_{i}" in un:
            _conv(out, f"pointnet.unet.down_convs.{i}.conv1", un[f"down_{i}"]["Conv_0"])
            _conv(out, f"pointnet.unet.down_convs.{i}.conv2", un[f"down_{i}"]["Conv_1"])
            i += 1
        i = 0
        while f"up_{i}" in un:
            up = un[f"up_{i}"]
            _conv_transpose(out, f"pointnet.unet.up_convs.{i}.upconv", up["ConvTranspose_0"])
            _conv(out, f"pointnet.unet.up_convs.{i}.conv1", up["Conv_0"])
            _conv(out, f"pointnet.unet.up_convs.{i}.conv2", up["Conv_1"])
            i += 1
        _conv(out, "pointnet.unet.conv_final", un["conv_final"])
    mlp = tree["mlp"]
    _dense(out, "mlp.lin_in", mlp["lin_in"])
    _dense(out, "mlp.lin_out", mlp["lin_out"])
    out["mlp.alpha"] = np.asarray(mlp["alpha"], np.float32).reshape(())
    i = 0
    while f"block_{i}" in mlp:
        _block(out, f"mlp.blocks.{i}", mlp[f"block_{i}"])
        if f"lin_z_{i}" in mlp:
            _dense(out, f"mlp.lin_z.{i}", mlp[f"lin_z_{i}"])
        i += 1
    _dense(out, "head_geo.fc", tree["head_geo"]["Dense_0"])
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


def flatten_params(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> {'a/b/c': array} (the npz layout of a params tree)."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(flatten_params(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def save_params_npz(path: str, tree: dict) -> None:
    np.savez(path, **flatten_params(tree))


def load_params_npz(path: str) -> dict:
    """An npz of '/'-joined keys -> the nested params tree."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree
