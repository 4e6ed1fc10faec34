"""JAX/flax GenNerf parameters <-> the port's state_dict.

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


def _arr(state: Dict, key: str) -> np.ndarray:
    return state[key].detach().cpu().numpy().astype(np.float32)


def _dense_inv(state: Dict, prefix: str) -> dict:
    p = {"kernel": np.ascontiguousarray(_arr(state, prefix + ".weight").T)}
    if prefix + ".bias" in state:
        p["bias"] = _arr(state, prefix + ".bias")
    return p


def _conv_inv(state: Dict, prefix: str) -> dict:
    return {"kernel": np.ascontiguousarray(_arr(state, prefix + ".weight").transpose(2, 3, 1, 0)),
            "bias": _arr(state, prefix + ".bias")}


def _conv_transpose_inv(state: Dict, prefix: str) -> dict:
    k = _arr(state, prefix + ".weight").transpose(2, 3, 0, 1)[::-1, ::-1]
    return {"kernel": np.ascontiguousarray(k), "bias": _arr(state, prefix + ".bias")}


def _block_inv(state: Dict, prefix: str) -> dict:
    p = {"Dense_0": _dense_inv(state, prefix + ".fc_0"), "Dense_1": _dense_inv(state, prefix + ".fc_1")}
    if prefix + ".shortcut.weight" in state:
        p["Dense_2"] = _dense_inv(state, prefix + ".shortcut")
    return p


def flax_params_from_gen_nerf(state: Dict[str, torch.Tensor]) -> dict:
    """GenNerf state_dict -> the flax `params` tree (nested dicts of numpy
    float32 arrays), the inverse of `gen_nerf_params_from_flax`: a model
    the port trains is written with `save_params_npz` as the npz the
    predict and render CLIs (and the JAX side) read."""
    pn = {"fc_pos": _dense_inv(state, "pointnet.fc_pos"), "fc_c": _dense_inv(state, "pointnet.fc_c")}
    i = 0
    while f"pointnet.blocks.{i}.fc_0.weight" in state:
        pn[f"block_{i}"] = _block_inv(state, f"pointnet.blocks.{i}")
        i += 1
    if "pointnet.unet.conv_final.weight" in state:
        un = {"conv_final": _conv_inv(state, "pointnet.unet.conv_final")}
        i = 0
        while f"pointnet.unet.down_convs.{i}.conv1.weight" in state:
            un[f"down_{i}"] = {"Conv_0": _conv_inv(state, f"pointnet.unet.down_convs.{i}.conv1"),
                               "Conv_1": _conv_inv(state, f"pointnet.unet.down_convs.{i}.conv2")}
            i += 1
        i = 0
        while f"pointnet.unet.up_convs.{i}.upconv.weight" in state:
            pre = f"pointnet.unet.up_convs.{i}"
            un[f"up_{i}"] = {"ConvTranspose_0": _conv_transpose_inv(state, pre + ".upconv"),
                             "Conv_0": _conv_inv(state, pre + ".conv1"),
                             "Conv_1": _conv_inv(state, pre + ".conv2")}
            i += 1
        pn["unet"] = un
    mlp = {"lin_in": _dense_inv(state, "mlp.lin_in"), "lin_out": _dense_inv(state, "mlp.lin_out"),
           "alpha": _arr(state, "mlp.alpha").reshape(())}
    i = 0
    while f"mlp.blocks.{i}.fc_0.weight" in state:
        mlp[f"block_{i}"] = _block_inv(state, f"mlp.blocks.{i}")
        if f"mlp.lin_z.{i}.weight" in state:
            mlp[f"lin_z_{i}"] = _dense_inv(state, f"mlp.lin_z.{i}")
        i += 1
    return {"pointnet": pn, "mlp": mlp, "head_geo": {"Dense_0": _dense_inv(state, "head_geo.fc")}}


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
