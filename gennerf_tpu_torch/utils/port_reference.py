"""Reference PyTorch Lightning checkpoints <-> the port's GenNerf and
VoxelNet (the port's counterpart of scripts/port_weights.py's gen_nerf
mode, gennerf_tpu/utils/port_gen_nerf.py and gennerf_tpu/utils/port_torch.py).

The reference's GenNerf and VoxelNet are LightningModules themselves, so a
`.ckpt` holds their parameters under `state_dict` with no `net.` prefix;
a `.pth` is such a state dict on its own. The port's modules carry the
reference's names (pointnet.fc_pos / blocks.{i}.fc_0|fc_1|shortcut / fc_c,
pointnet.unet.down_convs|up_convs|conv_final, mlp.lin_in / lin_z.{i} /
scale_z.{i} / blocks.{i}.fc_0|fc_1 / lin_out, head_geo.fc, merger.conv;
VoxelNet's backbone3d.* and heads3d.heads.0.decoders.{i}) and torch's
layouts, so a tensor moves over as it is, but for:

- `encoder.model.` (the torchvision ResNet) is the port's `spatial.resnet.`;
  its stages past the encoder's num_layers - 1 and its `fc` are unused keys;
- `mlp.alpha` is a parameter of the port that the reference lacks: it
  comes from the config's mlp.alpha (as port_resnetfc(alpha=) does), or
  from the checkpoint where the port's writer left it;
- BatchNorm's `num_batches_tracked` counters are dropped: neither flax's
  norm nor the port's keeps one.

Reading is strict: every port parameter and running statistic must come
from the checkpoint, with its shape; one that is missing raises with its
name and shape. `partial=True` leaves the missing ones at their init and
returns and prints their names instead. Two subtrees are known to need it,
because the reference's names for them are not documented: VoxelNet's 2D
`spatial.proj` and ResnetFC's LayerNorm, which the port names `mlp.ln.{i}`.
Checkpoint keys that no port parameter takes (a `head_sem`, a teacher's
weights, the ResNet's later stages) are returned and warned about.

The file is read by a restricted unpickler: a Lightning checkpoint also
pickles its hyper_parameters, loops and callback states with omegaconf and
lightning classes. The unpickler rebuilds tensors and the built-in
containers, and turns every other global into an inert stub without
importing its module, so nothing foreign runs and no package is needed.
Only `state_dict` is used, and `hyper_parameters` as plain data (a stub as
{"__class__": "module.name", "args": ..., "state": ...}).

The writer is the counterpart of export_gen_nerf_params: the port's
weights as a reference-named state dict, `{"state_dict": {name: tensor}}`.
It writes `mlp.alpha` only when it differs from the config's value (the
reference has no such key), and writes the two port-named subtrees above
under the port's names, so that the reader gives the same weights back.
"""
from __future__ import annotations

import collections
import copyreg
import pickle
import types
import warnings
import zipfile
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

RESNET_REFERENCE, RESNET_PORT = "encoder.model.", "spatial.resnet."

_DTYPES = {name: getattr(torch, name) for name in (
    "float64", "float32", "float16", "bfloat16", "int64", "int32", "int16", "int8", "uint8",
    "bool", "complex64", "complex128", "double", "float", "half", "long", "int", "short")}
_ALLOWED = {
    ("collections", "OrderedDict"): collections.OrderedDict,
    ("builtins", "set"): set, ("builtins", "frozenset"): frozenset,
    ("builtins", "list"): list, ("builtins", "dict"): dict, ("builtins", "tuple"): tuple,
    ("builtins", "slice"): slice, ("builtins", "complex"): complex,
    ("builtins", "object"): object,
    ("copyreg", "_reconstructor"): copyreg._reconstructor,
    **{("torch._utils", name): getattr(torch._utils, name) for name in (
        "_rebuild_tensor_v2", "_rebuild_parameter", "_rebuild_parameter_with_state")
       if hasattr(torch._utils, name)},
    ("torch", "Size"): torch.Size,
    ("torch", "device"): torch.device,
    **{("torch", name): dt for name, dt in _DTYPES.items()},
}


class Stub:
    """An inert stand-in for a global the restricted unpickler does not
    allow: it records its constructor arguments and its pickled state."""

    _qualname = "?"

    def __init__(self, *args, **kwargs):
        self._args, self._kwargs, self._state = args, kwargs, None

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj._args, obj._kwargs, obj._state = args, kwargs, None
        return obj

    def __setstate__(self, state):
        self._state = state

    def __setitem__(self, key, value):  # a dict subclass's items
        self.__dict__.setdefault("_items", {})[key] = value

    def append(self, value):  # a list subclass's items
        self.__dict__.setdefault("_list", []).append(value)

    def extend(self, values):
        self.__dict__.setdefault("_list", []).extend(values)

    def __repr__(self):
        return f"<stub {self._qualname}>"


class _Unpickler(pickle.Unpickler):
    _stubs: Dict = {}

    def find_class(self, module: str, name: str):
        allowed = _ALLOWED.get((module, name))
        if allowed is not None:
            return allowed
        key = (module, name)
        if key not in self._stubs:
            self._stubs[key] = type(name, (Stub,), {"__module__": "stub." + module,
                                                    "_qualname": f"{module}.{name}"})
        return self._stubs[key]


_restricted_pickle = types.ModuleType("restricted_pickle")
_restricted_pickle.Unpickler = _Unpickler
_restricted_pickle.load = lambda f, **kw: _Unpickler(f, **kw).load()
_restricted_pickle.__name__ = "restricted_pickle"


def weights_format(path: str) -> str:
    """'npz' (a params npz), 'torch' (a torch.save file: a reference
    .ckpt or .pth); anything else raises ValueError."""
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            names = z.namelist()
        if names and all(n.endswith(".npy") for n in names):
            return "npz"
        if any(n.endswith("data.pkl") for n in names):
            return "torch"
    else:
        with open(path, "rb") as f:
            head = f.read(2)
        if head[:1] == b"\x80":  # torch.save's legacy (non-zip) pickle stream
            return "torch"
    raise ValueError(f"{path}: not a params npz, a reference .ckpt nor a .pth")


def plain(x):
    """hyper_parameters as plain data: containers and scalars kept,
    tensors as lists, a stub as its class name, arguments and state."""
    if isinstance(x, Stub):
        out = {"__class__": x._qualname}
        if getattr(x, "_args", ()):
            out["args"] = plain(list(x._args))
        if getattr(x, "_state", None) is not None:
            out["state"] = plain(x._state)
        for attr in ("_items", "_list"):
            if attr in x.__dict__:
                out[attr[1:]] = plain(x.__dict__[attr])
        return out
    if isinstance(x, dict):
        return {repr(k) if isinstance(k, Stub) else k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, set, frozenset)):
        return [plain(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.tolist()
    return x


class ReferenceCheckpoint(NamedTuple):
    state_dict: Dict[str, torch.Tensor]
    hyper_parameters: Optional[dict]


def _restricted_load(path: str):
    """torch.load through the restricted unpickler, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_restricted_pickle)


def read_reference_checkpoint(path: str) -> ReferenceCheckpoint:
    """A reference Lightning `.ckpt` (its `state_dict` and
    `hyper_parameters`) or a state-dict `.pth`, through the restricted
    unpickler, tensors on the CPU."""
    if weights_format(path) != "torch":
        raise ValueError(f"{path} is not a torch checkpoint")
    obj = _restricted_load(path)
    if isinstance(obj, dict) and "state_dict" in obj:
        state, hparams = obj["state_dict"], obj.get("hyper_parameters")
    else:
        state, hparams = obj, None
    if not isinstance(state, dict) or not all(isinstance(v, torch.Tensor) for v in state.values()):
        raise ValueError(f"{path} holds no state dict of tensors")
    return ReferenceCheckpoint(dict(state), None if hparams is None else plain(hparams))


def is_reference_checkpoint(path: str) -> bool:
    """Whether a file is a Lightning checkpoint (a torch file with a
    `state_dict`), as opposed to the port's own training checkpoints."""
    try:
        obj = _restricted_load(path)
    except (pickle.UnpicklingError, RuntimeError, EOFError):  # not a torch file
        return False
    return isinstance(obj, dict) and "state_dict" in obj and "model" not in obj


class PortedState(NamedTuple):
    state: Dict[str, torch.Tensor]  # the port's state dict, every key filled
    unfilled: List[str]  # port keys left at init (partial=True)
    unused: List[str]    # checkpoint keys no port parameter takes


def port_reference_state(model: torch.nn.Module, reference: Dict[str, torch.Tensor],
                         partial: bool = False) -> PortedState:
    """A reference state dict -> the port model's state dict (see the module
    docstring). Raises KeyError naming every missing port parameter (unless
    `partial`) and ValueError on a shape mismatch."""
    target = model.state_dict()
    renamed = {}
    for key, value in reference.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key.startswith(RESNET_REFERENCE):
            key = RESNET_PORT + key[len(RESNET_REFERENCE):]
        renamed[key] = value
    if "mlp.alpha" in target and "mlp.alpha" not in renamed:
        renamed["mlp.alpha"] = torch.tensor(float(model.cfg.mlp.alpha))
    state, unfilled = {}, []
    for key, value in target.items():
        if key not in renamed:
            unfilled.append(key)
            state[key] = value
            continue
        src = renamed[key]
        if tuple(src.shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {key}: model {tuple(value.shape)} vs "
                             f"checkpoint {tuple(src.shape)}")
        state[key] = src.to(value.dtype)
    if unfilled and not partial:
        missing = ", ".join(f"{k} {tuple(target[k].shape)}" for k in unfilled)
        raise KeyError(f"the checkpoint lacks port parameters: {missing} "
                       "(partial=True keeps them at init)")
    unused = sorted(set(renamed) - set(target))
    return PortedState(state, unfilled, unused)


def load_reference(model: torch.nn.Module, path: str, partial: bool = False) -> PortedState:
    """Read a reference checkpoint into `model` (strict but for what
    `partial` leaves at init); prints the unfilled keys and warns about the
    unused ones."""
    ported = port_reference_state(model, read_reference_checkpoint(path).state_dict, partial)
    model.load_state_dict(ported.state)
    if ported.unfilled:
        print(f"{path}: left at init ({len(ported.unfilled)}): {', '.join(ported.unfilled)}",
              flush=True)
    if ported.unused:
        warnings.warn(f"{path}: {len(ported.unused)} checkpoint key(s) no port parameter "
                      f"takes: {', '.join(ported.unused)}")
    return ported


def reference_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The port model's weights under the reference's names (CPU tensors):
    `spatial.resnet.` as `encoder.model.`, `mlp.alpha` only where it
    differs from the config's (with a warning: the reference has none)."""
    out = {}
    for key, value in model.state_dict().items():
        value = value.detach().cpu().clone()
        if key == "mlp.alpha":
            if float(value) == float(np.float32(model.cfg.mlp.alpha)):
                continue
            warnings.warn(f"mlp.alpha {float(value)} differs from the config's "
                          f"{model.cfg.mlp.alpha}: written as mlp.alpha, a key the reference lacks")
        if key.startswith(RESNET_PORT):
            key = RESNET_REFERENCE + key[len(RESNET_PORT):]
        out[key] = value
    return out


def write_reference(model: torch.nn.Module, path: str) -> None:
    """`{"state_dict": reference_state_dict(model)}` with torch.save."""
    torch.save({"state_dict": reference_state_dict(model)}, path)
