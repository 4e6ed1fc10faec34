"""Depth metrics (the port's own copy of `eval_depth` from
gennerf_tpu/eval/metrics.py), numpy only."""
from __future__ import annotations

from typing import Dict

import numpy as np

DEPTH_METRICS = ("AbsRel", "AbsDiff", "SqRel", "RMSE", "LogRMSE", "r1", "r2", "r3", "complete")


def eval_depth(depth_pred: np.ndarray, depth_trgt: np.ndarray) -> Dict[str, float]:
    """2D depth metrics: AbsRel/AbsDiff/SqRel/RMSE/LogRMSE/delta<1.25^n over
    pixels valid (> 0) in both maps, and the share of predicted pixels."""
    mask1 = depth_pred > 0
    mask = (depth_trgt > 0) & mask1
    if mask.sum() == 0:
        return {k: 0.0 for k in DEPTH_METRICS}

    pred = depth_pred[mask]
    trgt = depth_trgt[mask]
    abs_diff = np.abs(pred - trgt)
    abs_rel = abs_diff / trgt
    sq_diff = abs_diff**2
    sq_rel = sq_diff / trgt
    sq_log_diff = (np.log(pred) - np.log(trgt)) ** 2
    thresh = np.maximum(pred / trgt, trgt / pred)
    r1 = (thresh < 1.25).astype(np.float64)
    r2 = (thresh < 1.25**2).astype(np.float64)
    r3 = (thresh < 1.25**3).astype(np.float64)

    return {
        "AbsRel": float(abs_rel.mean()),
        "AbsDiff": float(abs_diff.mean()),
        "SqRel": float(sq_rel.mean()),
        "RMSE": float(np.sqrt(sq_diff.mean())),
        "LogRMSE": float(np.sqrt(sq_log_diff.mean())),
        "r1": float(r1.mean()),
        "r2": float(r2.mean()),
        "r3": float(r3.mean()),
        "complete": float(mask1.mean()),
    }
