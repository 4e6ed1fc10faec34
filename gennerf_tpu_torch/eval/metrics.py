"""TSDF and depth metrics (the port's own copy of `eval_tsdf`,
`_resample_tsdf_to` and `eval_depth` from gennerf_tpu/eval/metrics.py),
numpy only. Volumes are arrays or `TSDF`s (whose CPU tensors numpy reads).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

def eval_tsdf(tsdf_pred, tsdf_trgt, align: bool = False) -> Dict[str, float]:
    """Masked TSDF L1 over the voxels the target observes (trgt < 1).

    When the grids differ (shape, origin or voxel size) and both sides are
    TSDFs, the prediction is first resampled at the target's voxels in
    world space (`_resample_tsdf_to`); same-shape grids compare voxel to
    voxel unless `align`, as the reference does."""
    pred = np.asarray(tsdf_pred.tsdf_vol if hasattr(tsdf_pred, "tsdf_vol") else tsdf_pred)
    trgt = np.asarray(tsdf_trgt.tsdf_vol if hasattr(tsdf_trgt, "tsdf_vol") else tsdf_trgt)
    have_grids = hasattr(tsdf_pred, "origin") and hasattr(tsdf_trgt, "origin")
    grids_differ = pred.shape != trgt.shape or (
        have_grids
        and (not np.allclose(np.asarray(tsdf_pred.origin).reshape(3),
                             np.asarray(tsdf_trgt.origin).reshape(3), atol=1e-6)
             or abs(float(tsdf_pred.voxel_size) - float(tsdf_trgt.voxel_size)) > 1e-9))
    if grids_differ or (align and have_grids):
        if not have_grids:
            raise ValueError(f"pred {pred.shape} vs target {trgt.shape}: raw arrays of "
                             "different shapes cannot be aligned (pass TSDF objects)")
        pred = _resample_tsdf_to(tsdf_pred, tsdf_trgt)
    mask = trgt < 1
    if mask.sum() == 0:
        return {"l1": 0.0}
    return {"l1": float(np.abs(pred[mask] - trgt[mask]).mean())}


def _resample_tsdf_to(tsdf_pred, tsdf_trgt, pred_convention: str = "linspace") -> np.ndarray:
    """pred's volume sampled trilinearly at trgt's voxels (world aligned),
    1.0 (unobserved) outside pred's volume. Decoded volumes live on the
    linspace grid (spacing voxel_size*n/(n-1), `pred_convention`
    'linspace'), fused ones on arange*voxel_size."""
    pred = np.asarray(tsdf_pred.tsdf_vol, np.float32)
    po = np.asarray(tsdf_pred.origin, np.float32).reshape(3)
    pvs = float(tsdf_pred.voxel_size)
    to = np.asarray(tsdf_trgt.origin, np.float32).reshape(3)
    tvs = float(tsdf_trgt.voxel_size)
    tshape = np.asarray(tsdf_trgt.tsdf_vol).shape
    if pred_convention == "linspace":
        spacing = [pvs * n / max(n - 1, 1) for n in pred.shape]
    else:
        spacing = [pvs] * 3
    axes = [to[a] + tvs * np.arange(tshape[a], dtype=np.float32) for a in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    coords = [(g - po[a]) / spacing[a] for a, g in enumerate((gx, gy, gz))]
    out = np.ones(tshape, np.float32)
    lo = [np.floor(c).astype(np.int64) for c in coords]
    fr = [c - low for c, low in zip(coords, lo)]
    inb = np.ones(tshape, bool)
    for a, c in enumerate(coords):
        # a coordinate on the last voxel plane is in bounds (its fraction is 0)
        inb &= (c >= 0) & (c <= pred.shape[a] - 1 + 1e-6)
    li = [np.clip(low, 0, pred.shape[a] - 1) for a, low in enumerate(lo)]
    hi = [np.clip(low + 1, 0, pred.shape[a] - 1) for a, low in enumerate(lo)]
    acc = np.zeros(tshape, np.float32)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((fr[0] if dx else 1 - fr[0]) * (fr[1] if dy else 1 - fr[1])
                     * (fr[2] if dz else 1 - fr[2]))
                acc += w * pred[hi[0] if dx else li[0], hi[1] if dy else li[1],
                                hi[2] if dz else li[2]]
    out[inb] = acc[inb]
    return out


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
