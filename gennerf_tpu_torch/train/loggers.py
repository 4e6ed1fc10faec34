"""Metric and artifact logging (the port's copy of gennerf_tpu/train/
loggers.py): the console logger, `CSVLogger`, the dependency-free
TensorBoard event writer, the local file sink `LocalWriter`, the
import-guarded external trackers, `log_hyperparameters` and the
`MetricsLogger` fan-out that the `logger` config group selects.

`TensorBoardLogger` hand-encodes Event protos into tfevents files (TFRecord
framing with masked CRC32C) that stock TensorBoard reads; its records are
byte for byte the JAX writer's. The external trackers (wandb, mlflow,
neptune, comet_ml, aim) are imported only inside their adapters'
constructors; a missing one is warned about and skipped. Under more than
one rank (parallel/), the console logger prefixes its rank and logs
WARNING and above on the others, and `MetricsLogger` writes on rank 0
only (the metrics are global and the same on every rank), as the JAX
package's gate does.
"""
from __future__ import annotations

import csv
import json
import logging
import os
import socket
import struct
import sys
import time
import warnings
from typing import Any, Dict, Optional

import numpy as np


def get_logger(name: str = "gennerf_tpu_torch",
               process_index: Optional[int] = None) -> logging.Logger:
    """Rank-prefixed console logger on stdout; a non-zero process logs at
    WARNING and above (the reference's RankedLogger filtering). The rank
    defaults to this process's in the process group; a rank's logger is
    its own (`name` and the rank)."""
    if process_index is None:
        from ..parallel.distributed import process_index as rank

        process_index = rank()
    if process_index:
        name = f"{name}.rank{process_index}"
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(
            logging.Formatter(f"[%(asctime)s][rank{process_index}][%(levelname)s] %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO if process_index == 0 else logging.WARNING)
        logger.propagate = False
    return logger


class CSVLogger:
    """Append scalar metric rows to metrics.csv (and metrics.jsonl) under
    save_dir/name; a row with a new key rewrites the csv with the widened
    header."""

    def __init__(self, save_dir: str, name: str = "csv"):
        self.dir = os.path.join(save_dir, name)
        os.makedirs(self.dir, exist_ok=True)
        self.csv_path = os.path.join(self.dir, "metrics.csv")
        self.jsonl_path = os.path.join(self.dir, "metrics.jsonl")
        self._fieldnames: Optional[list] = None

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        row = {"step": step}
        row.update({k: float(v) for k, v in metrics.items()})
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        if self._fieldnames is None or any(k not in self._fieldnames for k in row):
            old = []
            if self._fieldnames is not None and os.path.exists(self.csv_path):
                with open(self.csv_path) as f:
                    old = list(csv.DictReader(f))
            self._fieldnames = sorted(set(list(self._fieldnames or []) + list(row)))
            with open(self.csv_path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fieldnames)
                w.writeheader()
                for r in old:
                    w.writerow(r)
        with open(self.csv_path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self._fieldnames).writerow(row)

    def log_hparams(self, hparams: Dict[str, Any]) -> None:
        """hparams.yaml next to metrics.csv."""
        import yaml

        with open(os.path.join(self.dir, "hparams.yaml"), "w") as f:
            yaml.safe_dump(hparams, f, default_flow_style=False, sort_keys=False)


# -- the tfevents encoding ------------------------------------------------------

_CRC_TABLE = []
# below this many bytes the byte loop; above it the chunked numpy version
_CRC_CHUNKED_MIN = 1 << 14


def _crc_table() -> np.ndarray:
    if not _CRC_TABLE:
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return np.array(_CRC_TABLE, np.uint32)


def _crc32c(data: bytes) -> int:
    """CRC32-Castagnoli, the TFRecord checksum (zlib.crc32 is another
    polynomial). A long buffer is cut into 1024 chunks (4096 from 256 KiB
    on) whose registers numpy advances side by side from 0; the CRC is linear, so
    the chunks' registers fold into the buffer's by shifting each over
    the next chunk's length of zero bytes. The initial register
    0xFFFFFFFF enters as the first four bytes XORed with 0xFF (a reflected
    CRC's register meets the message's bytes low byte first)."""
    table = _crc_table()
    if len(data) < _CRC_CHUNKED_MIN:
        crc = 0xFFFFFFFF
        for b in data:
            crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
        return crc ^ 0xFFFFFFFF
    arr = np.frombuffer(data, np.uint8).copy()
    arr[:4] ^= 0xFF
    n_chunks = 1024 if len(arr) < 1 << 18 else 4096
    length = -(-len(arr) // n_chunks)
    # zero bytes in front leave a zero register as it is
    chunks = np.concatenate([np.zeros(n_chunks * length - len(arr), np.uint8),
                             arr]).reshape(n_chunks, length).astype(np.uint32)
    regs = np.zeros(n_chunks, np.uint32)
    for j in range(length):
        regs = table[(regs ^ chunks[:, j]) & 0xFF] ^ (regs >> 8)
    # shift[k][b]: the register b << 8k after `length` zero bytes
    shift = (np.arange(256, dtype=np.uint32)[None, :]
             << (8 * np.arange(4, dtype=np.uint32))[:, None]).reshape(-1)
    for _ in range(length):
        shift = table[shift & 0xFF] ^ (shift >> 8)
    shift = shift.reshape(4, 256).tolist()
    crc = 0
    for reg in regs.tolist():
        crc = (shift[0][crc & 0xFF] ^ shift[1][(crc >> 8) & 0xFF] ^ shift[2][(crc >> 16) & 0xFF]
               ^ shift[3][crc >> 24] ^ reg)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        out += bytes([b7 | (0x80 if n else 0)])
        if not n:
            return out


def _pb_bytes(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _pb_double(field: int, v: float) -> bytes:
    return _varint(field << 3 | 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _varint(field << 3 | 5) + struct.pack("<f", v)


def _pb_int(field: int, v: int) -> bytes:
    return _varint(field << 3) + _varint(v)


_pb_enum = _pb_int


def _tf_event(wall_time: float, step: int = 0, file_version: Optional[str] = None,
              scalars: Optional[Dict[str, float]] = None) -> bytes:
    """An Event proto (event.proto: wall_time=1 double, step=2 int64,
    file_version=3 string, summary=5; Summary.Value: tag=1 string,
    simple_value=2 float)."""
    msg = _pb_double(1, wall_time)
    if step:
        msg += _pb_int(2, step)
    if file_version is not None:
        msg += _pb_bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(_pb_bytes(1, _pb_bytes(1, tag.encode()) + _pb_float(2, float(v)))
                           for tag, v in scalars.items())
        msg += _pb_bytes(5, summary)
    return msg


def _tensor_proto(arr: np.ndarray) -> bytes:
    """A TensorProto (tensor.proto: dtype=1 enum, tensor_shape=2
    TensorShapeProto with Dim size=1, tensor_content=4 bytes); dtypes other
    than float32, int32 and uint8 go as float32."""
    dtypes = {np.dtype(np.float32): 1, np.dtype(np.int32): 3, np.dtype(np.uint8): 4}
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in dtypes:
        arr = arr.astype(np.float32)
    shape = b"".join(_pb_bytes(2, _pb_int(1, int(d))) for d in arr.shape)
    return _pb_enum(1, dtypes[arr.dtype]) + _pb_bytes(2, shape) + _pb_bytes(4, arr.tobytes())


def _summary_value_image(tag: str, png: bytes, h: int, w: int, colorspace: int = 3) -> bytes:
    """Summary.Value{tag=1, image=4 Summary.Image{height=1, width=2,
    colorspace=3, encoded_image_string=4}} (summary.proto)."""
    img = _pb_int(1, int(h)) + _pb_int(2, int(w)) + _pb_int(3, int(colorspace)) + _pb_bytes(4, png)
    return _pb_bytes(1, _pb_bytes(1, tag.encode()) + _pb_bytes(4, img))


# the TensorBoard mesh plugin's content types (plugin_data.proto)
_MESH_VERTEX, _MESH_FACE, _MESH_COLOR = 1, 2, 3


def _mesh_plugin_data(name: str, content_type: int, components: int, shape,
                      json_config: str = "{}") -> bytes:
    """tensorboard.mesh.MeshPluginData (plugin_data.proto): version=1,
    name=2, content_type=3, components=4, json_config=5, shape=6."""
    msg = (_pb_int(1, 0) + _pb_bytes(2, name.encode()) + _pb_enum(3, content_type)
           + _pb_int(4, components) + _pb_bytes(5, json_config.encode()))
    for d in shape:
        msg += _pb_int(6, int(d))
    return msg


def _summary_value_mesh_tensor(tag: str, name: str, content_type: int, components: int,
                               arr: np.ndarray) -> bytes:
    """Summary.Value{tag=1, metadata=9 SummaryMetadata{plugin_data=1
    PluginData{plugin_name=1 'mesh', content=2 MeshPluginData}}, tensor=8}."""
    plugin = _pb_bytes(1, b"mesh") + _pb_bytes(
        2, _mesh_plugin_data(name, content_type, components, arr.shape))
    return _pb_bytes(1, _pb_bytes(1, tag.encode()) + _pb_bytes(8, _tensor_proto(arr))
                     + _pb_bytes(9, _pb_bytes(1, plugin)))


def _pb_pbvalue(v) -> bytes:
    """google.protobuf.Value (struct.proto): null_value=1 enum,
    number_value=2 double, string_value=3 string, bool_value=4 bool."""
    if isinstance(v, bool):
        return _pb_enum(4, int(v))
    if isinstance(v, (int, float)):
        return _pb_double(2, float(v))
    if v is None:
        return _pb_enum(1, 0)
    return _pb_bytes(3, str(v).encode())


def _summary_value_hparams(hparams: Dict[str, Any]) -> bytes:
    """The Summary.Value carrying the hparams plugin's SessionStartInfo,
    the record TensorBoard's HPARAMS tab reads. plugin_data.proto:
    HParamsPluginData{version=1, session_start_info=3 SessionStartInfo{
    hparams=1 map<string, google.protobuf.Value>, start_time_secs=5}}; a
    map entry encodes as {key=1, value=2}; the tag is the plugin's fixed
    SESSION_START_INFO_TAG."""
    entries = b"".join(_pb_bytes(1, _pb_bytes(1, k.encode()) + _pb_bytes(2, _pb_pbvalue(v)))
                       for k, v in hparams.items())
    session_start = entries + _pb_double(5, time.time())
    plugin = _pb_bytes(1, b"hparams") + _pb_bytes(2, _pb_int(1, 0) + _pb_bytes(3, session_start))
    return _pb_bytes(1, _pb_bytes(1, b"_hparams_/session_start_info")
                     + _pb_bytes(9, _pb_bytes(1, plugin)))


def _flatten_hparams(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A nested config as dotted scalar keys (other values as strings)."""
    out: Dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_hparams(v, key + "."))
        elif isinstance(v, (str, int, float, bool)) or v is None:
            out[key] = v
        else:
            out[key] = str(v)
    return out


def _uint8_image(image) -> np.ndarray:
    """(H, W, C) uint8 from HWC or CHW, a float image min-max normalised."""
    arr = np.asarray(image)
    if arr.ndim == 3 and arr.shape[0] in (1, 3):
        arr = arr.transpose(1, 2, 0)
    if arr.dtype != np.uint8:
        lo, hi = float(arr.min()), float(arr.max())
        arr = ((arr - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)
    return arr


class TensorBoardLogger:
    """tfevents files without tensorflow or tensorboardX: scalars, PNG image
    summaries, the hparams plugin's record and mesh-plugin tensors in one
    events file under save_dir/name."""

    def __init__(self, save_dir: str, name: str = "tensorboard"):
        self.dir = os.path.join(save_dir, name)
        os.makedirs(self.dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(self.dir, fname)
        self._write(_tf_event(time.time(), file_version="brain.Event:2"))

    def _write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        with open(self.path, "ab") as f:
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(record)
            f.write(struct.pack("<I", _masked_crc(record)))

    def _write_summary(self, summary: bytes, step: int) -> None:
        msg = _pb_double(1, time.time())
        if step:
            msg += _pb_int(2, int(step))
        self._write(msg + _pb_bytes(5, summary))

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        scalars = {k: float(v) for k, v in metrics.items()}
        self._write(_tf_event(time.time(), step=int(step), scalars=scalars))

    def log_image(self, tag: str, image: np.ndarray, step: int = 0) -> None:
        """image: (H, W, C) or (C, H, W), uint8 (a float image is
        normalised to its range)."""
        from ..utils.image import encode_png

        arr = _uint8_image(image)
        h, w = arr.shape[:2]
        c = 1 if arr.ndim == 2 else arr.shape[2]
        self._write_summary(_summary_value_image(tag, encode_png(arr), h, w, c), step)

    def log_hparams(self, hparams: Dict[str, Any]) -> None:
        """The run's hyperparameters into the HPARAMS tab (nested configs
        flattened to dotted keys)."""
        self._write_summary(_summary_value_hparams(_flatten_hparams(hparams)), step=0)

    def log_mesh(self, tag: str, vertices: np.ndarray, faces: Optional[np.ndarray] = None,
                 colors: Optional[np.ndarray] = None, step: int = 0) -> None:
        """A mesh-plugin summary: vertices (N, 3) float, faces (F, 3) int,
        colors (N, 3) uint8, each its own tagged tensor batched to rank 3
        as the plugin requires."""
        components = 1 << _MESH_VERTEX
        if faces is not None:
            components |= 1 << _MESH_FACE
        if colors is not None:
            components |= 1 << _MESH_COLOR
        parts = [(f"{tag}_VERTEX", _MESH_VERTEX, np.asarray(vertices, np.float32)[None])]
        if faces is not None:
            parts.append((f"{tag}_FACE", _MESH_FACE, np.asarray(faces, np.int32)[None]))
        if colors is not None:
            parts.append((f"{tag}_COLOR", _MESH_COLOR, np.asarray(colors, np.uint8)[None]))
        summary = b"".join(_summary_value_mesh_tensor(t, tag, ct, components, a)
                           for t, ct, a in parts)
        self._write_summary(summary, step)


class LocalWriter:
    """File artifacts under save_dir/local/ at the tag's path: meshes as
    .ply, tensors as .npy, TSDFs as .npz, images as .png (a later write of
    a tag replaces the file); `mute` writes nothing."""

    def __init__(self, save_dir: str, mute: bool = False):
        self.dir = os.path.join(save_dir, "local")
        self.mute = mute

    def _path(self, rel: str, ext: str) -> str:
        path = os.path.join(self.dir, rel + ext)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return path

    def log_mesh(self, mesh, name: str) -> None:
        if not self.mute:
            mesh.export(self._path(name, ".ply"))

    def log_tensor(self, tensor, name: str) -> None:
        if not self.mute:
            np.save(self._path(name, ".npy"), np.asarray(tensor))

    def log_tsdf(self, tsdf, name: str) -> None:
        if not self.mute:
            tsdf.save(self._path(name, ".npz"))

    def log_image(self, image, name: str) -> None:
        if not self.mute:
            from ..utils.image import write_png

            write_png(self._path(name, ".png"), _uint8_image(image))


# -- external trackers, each imported only when its adapter is built -----------

class _WandbLogger:
    """wandb scalars (configs/logger/wandb.yaml)."""

    def __init__(self, cfg: Dict[str, Any]):
        import wandb

        self.run = wandb.init(project=cfg.get("project", "gennerf_tpu"), name=cfg.get("name"),
                              dir=cfg.get("save_dir"), mode=cfg.get("mode", "offline"))

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        self.run.log({k: float(v) for k, v in metrics.items()}, step=step)

    def log_hparams(self, hparams: Dict[str, Any]) -> None:
        self.run.config.update(hparams, allow_val_change=True)


class _MlflowLogger:
    """mlflow scalars (configs/logger/mlflow.yaml)."""

    def __init__(self, cfg: Dict[str, Any]):
        import mlflow

        self._m = mlflow
        if cfg.get("tracking_uri"):
            mlflow.set_tracking_uri(cfg["tracking_uri"])
        if cfg.get("experiment_name"):
            mlflow.set_experiment(cfg["experiment_name"])
        self.run = mlflow.start_run(run_name=cfg.get("run_name"))

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        self._m.log_metrics({k: float(v) for k, v in metrics.items()}, step=step)

    def log_hparams(self, hparams: Dict[str, Any]) -> None:
        self._m.log_params({k: str(v) for k, v in hparams.items()})


class _NeptuneLogger:
    """neptune scalars (configs/logger/neptune.yaml)."""

    def __init__(self, cfg: Dict[str, Any]):
        import neptune

        self.run = neptune.init_run(project=cfg.get("project"), name=cfg.get("name"),
                                    mode=cfg.get("mode", "async"))

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        for k, v in metrics.items():
            self.run[k].append(float(v), step=step)

    def log_hparams(self, hparams: Dict[str, Any]) -> None:
        self.run["parameters"] = hparams


class _CometLogger:
    """comet_ml scalars (configs/logger/comet.yaml)."""

    def __init__(self, cfg: Dict[str, Any]):
        import comet_ml

        self.exp = comet_ml.Experiment(project_name=cfg.get("project_name"),
                                       experiment_key=cfg.get("experiment_key"))

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        self.exp.log_metrics({k: float(v) for k, v in metrics.items()}, step=step)

    def log_hparams(self, hparams: Dict[str, Any]) -> None:
        self.exp.log_parameters(hparams)


class _AimLogger:
    """aim scalars (configs/logger/aim.yaml)."""

    def __init__(self, cfg: Dict[str, Any]):
        import aim

        self.run = aim.Run(repo=cfg.get("repo"), experiment=cfg.get("experiment"))

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        for k, v in metrics.items():
            self.run.track(float(v), name=k, step=step)

    def log_hparams(self, hparams: Dict[str, Any]) -> None:
        for k, v in hparams.items():
            self.run[k] = v


_OPTIONAL_BACKENDS = {"mlflow": _MlflowLogger, "neptune": _NeptuneLogger,
                      "comet": _CometLogger, "aim": _AimLogger}


def log_hyperparameters(cfg: Dict[str, Any], model, logger: "MetricsLogger") -> None:
    """The run's hyperparameters to every backend: the model, data,
    trainer, callbacks and extras subtrees, task_name, tags, ckpt_path and
    seed, and the model's parameter counts. As in the JAX package, every
    parameter trains and BatchNorm statistics (buffers here) are not
    parameters, so non_trainable is 0."""
    hparams: Dict[str, Any] = {}
    if "model" in cfg:
        hparams["model"] = cfg["model"]
    n = sum(int(p.numel()) for p in model.parameters())
    hparams["model/params/total"] = n
    hparams["model/params/trainable"] = n
    hparams["model/params/non_trainable"] = 0
    for key in ("data", "trainer", "callbacks", "extras"):
        if cfg.get(key) is not None:
            hparams[key] = cfg[key]
    for key in ("task_name", "tags", "ckpt_path", "seed"):
        hparams[key] = cfg.get(key)
    logger.log_hparams(hparams)


class MetricsLogger:
    """The backends of a `logger` config group (csv, tensorboard, wandb,
    mlflow, neptune, comet, aim; CSV when none is named) and the local
    artifact sink `.local`; every log call fans out to each backend that
    takes it."""

    def __init__(self, save_dir: str, cfg: Optional[Dict[str, Any]] = None):
        cfg = cfg or {}
        self.scalar_loggers = []
        if "csv" in cfg:
            self.scalar_loggers.append(CSVLogger(cfg["csv"].get("save_dir", save_dir)))
        if "tensorboard" in cfg:
            self.scalar_loggers.append(
                TensorBoardLogger(cfg["tensorboard"].get("save_dir", save_dir)))
        if "wandb" in cfg:
            try:
                self.scalar_loggers.append(_WandbLogger(cfg["wandb"]))
            except ImportError:
                warnings.warn("wandb not installed; falling back to CSV")
                self.scalar_loggers.append(CSVLogger(save_dir))
        for key, cls in _OPTIONAL_BACKENDS.items():
            if key in cfg:
                try:
                    self.scalar_loggers.append(cls(cfg[key] or {}))
                except ImportError:
                    warnings.warn(f"logger backend '{key}' requested but not installed; skipping")
        if not self.scalar_loggers:
            self.scalar_loggers.append(CSVLogger(save_dir))
        local_cfg = cfg.get("local", {})
        self.local = LocalWriter(local_cfg.get("save_dir", save_dir),
                                 mute=local_cfg.get("mute_local", False))

    @staticmethod
    def _rank0() -> bool:
        from ..parallel.platform import is_rank0

        return is_rank0()

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        if not self._rank0():
            return
        for lg in self.scalar_loggers:
            lg.log_metrics(metrics, step)

    def log_hparams(self, hparams: Dict[str, Any]) -> None:
        if not self._rank0():
            return
        for lg in self.scalar_loggers:
            if hasattr(lg, "log_hparams"):
                lg.log_hparams(hparams)

    def log_image(self, tag: str, image, step: int = 0) -> None:
        """To every backend that takes images (the tfevents writer) and to
        the local PNG sink."""
        if not self._rank0():
            return
        for lg in self.scalar_loggers:
            if hasattr(lg, "log_image"):
                lg.log_image(tag, np.asarray(image), step)
        self.local.log_image(image, tag)

    def log_mesh(self, tag: str, mesh, step: int = 0) -> None:
        """`mesh` (utils.mesh.Mesh) as mesh-plugin summaries to every backend
        that takes them and as a .ply to the local sink."""
        if not self._rank0():
            return
        verts = np.asarray(mesh.vertices, np.float32)
        faces = np.asarray(mesh.faces, np.int32) if mesh.faces is not None else None
        colors = mesh.vertex_colors
        colors = np.asarray(colors, np.uint8) if colors is not None else None
        for lg in self.scalar_loggers:
            if hasattr(lg, "log_mesh"):
                lg.log_mesh(tag, verts, faces, colors, step)
        self.local.log_mesh(mesh, tag)
