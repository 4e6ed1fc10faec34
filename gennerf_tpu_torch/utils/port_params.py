"""JAX/flax GenNerf and VoxelNet variables <-> the port's state_dict.

The input is the flax `params` tree (and, with the spatial encoder, its
`batch_stats` tree) as nested dicts of numpy arrays (no JAX needed to read
them). Dense kernels (in, out) transpose to torch's (out, in); Conv kernels
(kh, kw, I, O) become (O, I, kh, kw); flax's ConvTranspose kernel is the
spatial flip of torch's ConvTranspose2d weight (I, O, kh, kw). ResnetFC's
`alpha` and the TSDF head carry over; SPADE's `scale_z_{i}` is
`mlp.scale_z.{i}`, the LayerNorm `ln_{i}` (`scale`/`bias`) is
`mlp.ln.{i}` (`weight`/`bias`), the learned merger's `merger/merge_conv`
is `merger.conv`, and the grid's 3D U-Net `pointnet/unet3d/enc_{l}` /
`dec_{l}` (`Conv_k`, `GroupNorm_k`) / `final` is `pointnet.unet3d.enc.{l}` /
`dec.{l}` (`conv_k`, `norm_k`) / `final`, its Conv3d kernels (kd, kh, kw,
I, O) becoming (O, I, kd, kh, kw). The spatial encoder's ResNet maps
onto torchvision's names: `layer{s}_{b}` -> `layer{s}.{b}`,
`down_conv`/`down_bn` -> `downsample.0`/`downsample.1`, BatchNorm
`scale`/`bias` -> `weight`/`bias` and its batch_stats `mean`/`var` ->
`running_mean`/`running_var`.

VoxelNet's 3D backbone maps the JAX module names onto the reference's:
`down0_b{j}` -> `layers_down.0.{j}`, `down{i}_conv` / `down{i}_norm` ->
`layers_down.{i}.0` / `.1`, `down{i}_b{j}` -> `layers_down.{i}.{4+j}`,
`up{i}_conv` -> `layers_up_conv.{i}`, `proj{i}` -> `proj.{i}`, `up{i}_b{j}`
-> `layers_up_res.{i}.{j}`, a block's `down` -> `downsample` (each norm's
`BatchNorm_0` level dropped); Conv3d kernels (kd, kh, kw, I, O) become (O,
I, kd, kh, kw); the head's `tsdf_head/decoder_{i}` Dense kernel (C, 1)
becomes the 1x1x1 Conv3d weight `heads3d.heads.0.decoders.{i}` (1, C, 1,
1, 1).

A params npz ('/'-joined keys, `save_params_npz`) holds the params tree at
its root and, for a model with running statistics, the batch_stats tree
under `batch_stats/` (`gen_nerf_npz_tree` / `voxel_net_npz_tree` build
both). Reading orbax
checkpoints is left to the JAX side: scripts/orbax_to_npz.py writes a
JAX run's checkpoint in this layout, and `load_params_npz` reads it here.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch


def _dense(out: Dict, prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = np.asarray(p["kernel"], np.float32).T
    if "bias" in p:
        out[prefix + ".bias"] = np.asarray(p["bias"], np.float32)


def _conv(out: Dict, prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1)
    if "bias" in p:
        out[prefix + ".bias"] = np.asarray(p["bias"], np.float32)


def _batch_norm(out: Dict, prefix: str, p: dict, stats: Optional[dict]) -> None:
    out[prefix + ".weight"] = np.asarray(p["scale"], np.float32)
    out[prefix + ".bias"] = np.asarray(p["bias"], np.float32)
    if stats is not None:
        out[prefix + ".running_mean"] = np.asarray(stats["mean"], np.float32)
        out[prefix + ".running_var"] = np.asarray(stats["var"], np.float32)


_BLOCK = re.compile(r"layer(\d+)_(\d+)")


def resnet_state_from_flax(params: dict, stats: Optional[dict], prefix: str = "") -> Dict:
    """flax ResNetStages params (and batch_stats) -> {torchvision name: array}."""
    out: Dict[str, np.ndarray] = {}
    stats = stats or {}
    for name, node in params.items():
        if name == "conv1":
            _conv(out, prefix + "conv1", node)
        elif name == "bn1":
            _batch_norm(out, prefix + "bn1", node, stats.get("bn1"))
        else:
            stage, block = _BLOCK.fullmatch(name).groups()
            pre = f"{prefix}layer{stage}.{block}."
            for sub, p in node.items():
                key = pre + {"down_conv": "downsample.0", "down_bn": "downsample.1"}.get(sub, sub)
                if "kernel" in p:
                    _conv(out, key, p)
                else:
                    _batch_norm(out, key, p, stats.get(name, {}).get(sub))
    return out


def _conv3d(out: Dict, prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = np.asarray(p["kernel"], np.float32).transpose(4, 3, 0, 1, 2)
    if "bias" in p:
        out[prefix + ".bias"] = np.asarray(p["bias"], np.float32)


def _norm(out: Dict, prefix: str, p: dict) -> None:
    """A LayerNorm or GroupNorm (no running statistics)."""
    out[prefix + ".weight"] = np.asarray(p["scale"], np.float32)
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


def gen_nerf_params_from_flax(tree: dict, batch_stats: Optional[dict] = None
                              ) -> Dict[str, torch.Tensor]:
    """flax GenNerf `params` (nested dicts of arrays) and `batch_stats` ->
    GenNerf state_dict. A `batch_stats` branch inside `tree` (the npz
    layout) serves when `batch_stats` is not given."""
    if "batch_stats" in tree:
        tree = dict(tree)
        stats = tree.pop("batch_stats")
        batch_stats = stats if batch_stats is None else batch_stats
    out: Dict[str, np.ndarray] = {}
    if "spatial" in tree:
        sp = tree["spatial"]
        out.update(resnet_state_from_flax(sp["resnet"], ((batch_stats or {}).get("spatial") or {})
                                          .get("resnet"), "spatial.resnet."))
        if "proj" in sp:
            _conv(out, "spatial.proj", sp["proj"])
    if "pointnet" in tree:
        _pointnet(out, tree["pointnet"])
    if "merger" in tree:
        _conv(out, "merger.conv", tree["merger"]["merge_conv"])
    _mlp_and_head(out, tree)
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


def _pointnet(out: Dict, pn: dict) -> None:
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
    if "unet3d" in pn:
        for name, node in pn["unet3d"].items():
            if name == "final":
                _conv3d(out, "pointnet.unet3d.final", node)
                continue
            side, level = name.split("_")
            for sub, p in node.items():
                kind, k = sub.split("_")
                key = f"pointnet.unet3d.{side}.{level}.{'conv' if kind == 'Conv' else 'norm'}_{k}"
                (_conv3d if kind == "Conv" else _norm)(out, key, p)


def _mlp_and_head(out: Dict, tree: dict) -> None:
    mlp = tree["mlp"]
    _dense(out, "mlp.lin_in", mlp["lin_in"])
    _dense(out, "mlp.lin_out", mlp["lin_out"])
    out["mlp.alpha"] = np.asarray(mlp["alpha"], np.float32).reshape(())
    i = 0
    while f"block_{i}" in mlp:
        _block(out, f"mlp.blocks.{i}", mlp[f"block_{i}"])
        if f"lin_z_{i}" in mlp:
            _dense(out, f"mlp.lin_z.{i}", mlp[f"lin_z_{i}"])
        if f"scale_z_{i}" in mlp:
            _dense(out, f"mlp.scale_z.{i}", mlp[f"scale_z_{i}"])
        if f"ln_{i}" in mlp:
            _norm(out, f"mlp.ln.{i}", mlp[f"ln_{i}"])
        i += 1
    _dense(out, "head_geo.fc", tree["head_geo"]["Dense_0"])


def _arr(state: Dict, key: str) -> np.ndarray:
    return state[key].detach().cpu().numpy().astype(np.float32)


def _dense_inv(state: Dict, prefix: str) -> dict:
    p = {"kernel": np.ascontiguousarray(_arr(state, prefix + ".weight").T)}
    if prefix + ".bias" in state:
        p["bias"] = _arr(state, prefix + ".bias")
    return p


def _conv_inv(state: Dict, prefix: str) -> dict:
    p = {"kernel": np.ascontiguousarray(_arr(state, prefix + ".weight").transpose(2, 3, 1, 0))}
    if prefix + ".bias" in state:
        p["bias"] = _arr(state, prefix + ".bias")
    return p


def _resnet_inv(state: Dict, prefix: str):
    """(params, batch_stats) of the flax ResNetStages under `prefix`."""
    params, stats = {}, {}
    for key in state:
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split(".")
        if parts[-1] == "weight" and parts[0] == "conv1":
            params["conv1"] = _conv_inv(state, prefix + "conv1")
        elif parts[-1] == "running_mean":
            module = ".".join(parts[:-1])
            bn = {"scale": _arr(state, prefix + module + ".weight"),
                  "bias": _arr(state, prefix + module + ".bias")}
            st = {"mean": _arr(state, prefix + module + ".running_mean"),
                  "var": _arr(state, prefix + module + ".running_var")}
            if len(parts) == 2:  # the stem's bn1
                params[parts[0]], stats[parts[0]] = bn, st
            else:
                block = f"{parts[0]}_{parts[1]}"
                sub = "down_bn" if parts[2] == "downsample" else parts[2]
                params.setdefault(block, {})[sub] = bn
                stats.setdefault(block, {})[sub] = st
        elif parts[-1] == "weight" and len(parts) > 2 and (
                parts[2].startswith("conv") or parts[2:4] == ["downsample", "0"]):
            block = f"{parts[0]}_{parts[1]}"
            sub = "down_conv" if parts[2] == "downsample" else parts[2]
            params.setdefault(block, {})[sub] = _conv_inv(state, prefix + ".".join(parts[:-1]))
    return params, stats


def _conv3d_inv(state: Dict, prefix: str) -> dict:
    w = _arr(state, prefix + ".weight").transpose(2, 3, 4, 1, 0)
    p = {"kernel": np.ascontiguousarray(w)}
    if prefix + ".bias" in state:
        p["bias"] = _arr(state, prefix + ".bias")
    return p


def _norm_inv(state: Dict, prefix: str) -> dict:
    return {"scale": _arr(state, prefix + ".weight"), "bias": _arr(state, prefix + ".bias")}


def _conv_transpose_inv(state: Dict, prefix: str) -> dict:
    k = _arr(state, prefix + ".weight").transpose(2, 3, 0, 1)[::-1, ::-1]
    return {"kernel": np.ascontiguousarray(k), "bias": _arr(state, prefix + ".bias")}


def _block_inv(state: Dict, prefix: str) -> dict:
    p = {"Dense_0": _dense_inv(state, prefix + ".fc_0"), "Dense_1": _dense_inv(state, prefix + ".fc_1")}
    if prefix + ".shortcut.weight" in state:
        p["Dense_2"] = _dense_inv(state, prefix + ".shortcut")
    return p


def flax_variables_from_gen_nerf(state: Dict[str, torch.Tensor]):
    """GenNerf state_dict -> (the flax `params` tree, the `batch_stats`
    tree) as nested dicts of numpy float32 arrays, the inverse of
    `gen_nerf_params_from_flax`; batch_stats is {} without the spatial
    encoder."""
    params, stats = {}, {}
    if "spatial.resnet.conv1.weight" in state:
        resnet, resnet_stats = _resnet_inv(state, "spatial.resnet.")
        params["spatial"] = {"resnet": resnet}
        stats["spatial"] = {"resnet": resnet_stats}
        if "spatial.proj.weight" in state:
            params["spatial"]["proj"] = _conv_inv(state, "spatial.proj")
    if "pointnet.fc_pos.weight" in state:
        params["pointnet"] = _pointnet_inv(state)
    if "merger.conv.weight" in state:
        params["merger"] = {"merge_conv": _conv_inv(state, "merger.conv")}
    params.update(_mlp_and_head_inv(state))
    return params, stats


def flax_params_from_gen_nerf(state: Dict[str, torch.Tensor]) -> dict:
    """GenNerf state_dict -> the flax `params` tree (see
    flax_variables_from_gen_nerf)."""
    return flax_variables_from_gen_nerf(state)[0]


def gen_nerf_npz_tree(state: Dict[str, torch.Tensor]) -> dict:
    """The tree `save_params_npz` writes for a model the port trains: the
    params at the root and, when the model has running statistics, a
    `batch_stats` branch beside them. The predict and render CLIs read it
    back with `gen_nerf_params_from_flax(load_params_npz(path))`."""
    params, stats = flax_variables_from_gen_nerf(state)
    return {**params, "batch_stats": stats} if stats else params


def _pointnet_inv(state: Dict) -> dict:
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
    if "pointnet.unet3d.final.weight" in state:
        u3 = {"final": _conv3d_inv(state, "pointnet.unet3d.final")}
        for key in state:
            parts = key.split(".")
            if parts[:2] != ["pointnet", "unet3d"] or parts[2] == "final" or parts[-1] != "weight":
                continue
            side, level, (kind, k) = parts[2], parts[3], parts[4].split("_")
            prefix = ".".join(parts[:-1])
            u3.setdefault(f"{side}_{level}", {})[
                f"Conv_{k}" if kind == "conv" else f"GroupNorm_{k}"] = (
                _conv3d_inv(state, prefix) if kind == "conv" else _norm_inv(state, prefix))
        pn["unet3d"] = u3
    return pn


def _mlp_and_head_inv(state: Dict) -> dict:
    mlp = {"lin_in": _dense_inv(state, "mlp.lin_in"), "lin_out": _dense_inv(state, "mlp.lin_out"),
           "alpha": _arr(state, "mlp.alpha").reshape(())}
    i = 0
    while f"mlp.blocks.{i}.fc_0.weight" in state:
        mlp[f"block_{i}"] = _block_inv(state, f"mlp.blocks.{i}")
        if f"mlp.lin_z.{i}.weight" in state:
            mlp[f"lin_z_{i}"] = _dense_inv(state, f"mlp.lin_z.{i}")
        if f"mlp.scale_z.{i}.weight" in state:
            mlp[f"scale_z_{i}"] = _dense_inv(state, f"mlp.scale_z.{i}")
        if f"mlp.ln.{i}.weight" in state:
            mlp[f"ln_{i}"] = _norm_inv(state, f"mlp.ln.{i}")
        i += 1
    return {"mlp": mlp, "head_geo": {"Dense_0": _dense_inv(state, "head_geo.fc")}}


_B3D_FLAX = [  # (flax name under backbone3d, its torch prefix), both ways
    (re.compile(r"down0_b(\d+)"), "layers_down.0.{0}"),
    (re.compile(r"down(\d+)_conv"), "layers_down.{0}.0"),
    (re.compile(r"down(\d+)_norm"), "layers_down.{0}.1"),
    (re.compile(r"down(\d+)_b(\d+)"), None),  # layers_down.{i}.{4 + j}
    (re.compile(r"up(\d+)_conv"), "layers_up_conv.{0}"),
    (re.compile(r"proj(\d+)"), "proj.{0}"),
    (re.compile(r"up(\d+)_b(\d+)"), "layers_up_res.{0}.{1}"),
]
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}


def _b3d_prefix(name: str) -> str:
    for pattern, fmt in _B3D_FLAX:
        m = pattern.fullmatch(name)
        if m:
            return (f"layers_down.{m[1]}.{4 + int(m[2])}" if fmt is None
                    else fmt.format(*m.groups()))
    raise KeyError(f"unknown backbone3d module {name!r}")


def _b3d_flax_name(parts) -> tuple:
    """torch key parts under backbone3d (without the leaf) -> flax path."""
    if parts[0] == "layers_down":
        i, k = int(parts[1]), int(parts[2])
        if i == 0:
            return (f"down0_b{k}",) + _b3d_sub(parts[3:])
        if k < 2:
            return (f"down{i}_{'conv' if k == 0 else 'norm'}",) + _b3d_sub(parts[3:], k == 1)
        return (f"down{i}_b{k - 4}",) + _b3d_sub(parts[3:])
    if parts[0] == "layers_up_conv":
        return (f"up{parts[1]}_conv",)
    if parts[0] == "proj":
        return (f"proj{parts[1]}",) + _b3d_sub(parts[2:])
    if parts[0] == "layers_up_res":
        return (f"up{parts[1]}_b{parts[2]}",) + _b3d_sub(parts[3:])
    raise KeyError(".".join(parts))


def _b3d_sub(parts, norm: bool = False) -> tuple:
    """Sub-module names inside a block / projection: norms gain flax's
    BatchNorm_0 level, `downsample` is `down`."""
    if not parts:
        return ("BatchNorm_0",) if norm else ()
    name = {"downsample": "down"}.get(parts[0], parts[0])
    return (name, "BatchNorm_0") if name.startswith(("bn", "norm")) else (name,)


def _leaves(tree: dict, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def voxel_net_params_from_flax(tree: dict, batch_stats: Optional[dict] = None
                               ) -> Dict[str, torch.Tensor]:
    """flax VoxelNet `params` and `batch_stats` (a `batch_stats` branch of
    `tree`, the npz layout, serves when not given) -> VoxelNet state_dict."""
    tree = dict(tree)
    stats = tree.pop("batch_stats", None)
    batch_stats = stats if batch_stats is None else batch_stats
    batch_stats = batch_stats or {}
    out: Dict[str, np.ndarray] = {}
    sp = tree["spatial"]
    out.update(resnet_state_from_flax(sp["resnet"], (batch_stats.get("spatial") or {})
                                      .get("resnet"), "spatial.resnet."))
    _conv(out, "spatial.proj", sp["proj"])
    for branch in (tree["backbone3d"], batch_stats.get("backbone3d") or {}):
        for path, v in _leaves(branch):
            sub = [p for p in path[1:-1] if p != "BatchNorm_0"]
            key = ".".join(["backbone3d", _b3d_prefix(path[0])] + [
                {"down": "downsample"}.get(p, p) for p in sub] + [_LEAF[path[-1]]])
            v = np.asarray(v, np.float32)
            out[key] = v.transpose(4, 3, 0, 1, 2) if path[-1] == "kernel" else v
    for name, p in tree["heads3d"]["tsdf_head"].items():
        i = int(name.removeprefix("decoder_"))
        k = np.asarray(p["kernel"], np.float32)  # (C, 1)
        out[f"heads3d.heads.0.decoders.{i}.weight"] = k.T.reshape(1, -1, 1, 1, 1)
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


def flax_variables_from_voxel_net(state: Dict[str, torch.Tensor]):
    """VoxelNet state_dict -> (the flax `params` tree, the `batch_stats`
    tree), the inverse of `voxel_net_params_from_flax`."""
    resnet, resnet_stats = _resnet_inv(state, "spatial.resnet.")
    params = {"spatial": {"resnet": resnet, "proj": _conv_inv(state, "spatial.proj")},
              "backbone3d": {}, "heads3d": {"tsdf_head": {}}}
    stats = {"spatial": {"resnet": resnet_stats}, "backbone3d": {}}
    inverse = {v: k for k, v in _LEAF.items() if k != "scale"}
    for key in state:
        parts = key.split(".")
        if parts[0] == "backbone3d":
            leaf = parts[-1]
            if leaf == "num_batches_tracked":
                continue
            path = _b3d_flax_name(parts[1:-1])
            is_norm = path[-1] == "BatchNorm_0"
            name = ("scale" if is_norm and leaf == "weight" else inverse[leaf])
            node = (stats if leaf.startswith("running_") else params)["backbone3d"]
            for p in path:
                node = node.setdefault(p, {})
            v = _arr(state, key)
            node[name] = np.ascontiguousarray(v.transpose(2, 3, 4, 1, 0)) if name == "kernel" else v
        elif parts[0] == "heads3d" and parts[-1] == "weight":
            w = _arr(state, key)  # (1, C, 1, 1, 1)
            params["heads3d"]["tsdf_head"][f"decoder_{parts[-2]}"] = {
                "kernel": np.ascontiguousarray(w.reshape(1, -1).T)}
    return params, stats


def voxel_net_npz_tree(state: Dict[str, torch.Tensor]) -> dict:
    """The tree `save_params_npz` writes for a VoxelNet: the params at the
    root, the running statistics under `batch_stats`."""
    params, stats = flax_variables_from_voxel_net(state)
    return {**params, "batch_stats": stats}


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
