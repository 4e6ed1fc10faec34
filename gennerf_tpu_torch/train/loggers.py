"""Metric and artifact logging (the port's copy of `CSVLogger` and of the
local file sink `LocalWriter` from gennerf_tpu/train/loggers.py; no
tfevents)."""
from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, Optional


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


class LocalWriter:
    """File artifacts under save_dir/local/: meshes as .ply and TSDFs as
    .npz, at the tag's path (a later write of a tag replaces the file)."""

    def __init__(self, save_dir: str):
        self.dir = os.path.join(save_dir, "local")

    def _path(self, rel: str, ext: str) -> str:
        path = os.path.join(self.dir, rel + ext)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return path

    def log_mesh(self, mesh, name: str) -> None:
        mesh.export(self._path(name, ".ply"))

    def log_tsdf(self, tsdf, name: str) -> None:
        tsdf.save(self._path(name, ".npz"))
