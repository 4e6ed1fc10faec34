"""Scalar metric logging (the port's copy of `CSVLogger` from
gennerf_tpu/train/loggers.py)."""
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
