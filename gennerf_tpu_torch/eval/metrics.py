"""TSDF, mesh and depth metrics (the port's own copy of
gennerf_tpu/eval/metrics.py), numpy and the port's host library (the
KD-tree of `eval_mesh`). Volumes are arrays or `TSDF`s (whose CPU tensors
numpy reads).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..utils.native import nn_distances


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


def _sample_surface(mesh, voxel: float = 0.02) -> np.ndarray:
    """The mesh's vertices downsampled on a `voxel`-metre hash grid: one
    point, the centroid, per occupied cell (the reference's Open3D
    `voxel_down_sample`), unbiased on unevenly tessellated meshes."""
    verts = np.asarray(mesh.vertices, np.float32)
    if len(verts) == 0:
        return verts
    cells = np.floor(verts / voxel).astype(np.int64)
    _, inv, counts = np.unique(cells, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((len(counts), 3), np.float64)
    np.add.at(sums, inv.reshape(-1), verts)
    return (sums / counts[:, None]).astype(np.float32)


def eval_mesh(mesh_pred, mesh_trgt, threshold: float = 0.05,
              down_sample: float = 0.02) -> Dict[str, float]:
    """Mesh precision, recall and F-score at `threshold` metres over both
    meshes' vertices downsampled at `down_sample` metres: prec the share of
    predicted points within the threshold of the target, recal the share of
    target points within it of the prediction, dist1 / dist2 the mean
    distances pred -> target / target -> pred. An empty side gives
    inf distances and zero scores."""
    pts_pred = _sample_surface(mesh_pred, down_sample)
    pts_trgt = _sample_surface(mesh_trgt, down_sample)
    if len(pts_pred) == 0 or len(pts_trgt) == 0:
        return {"dist1": np.inf, "dist2": np.inf, "prec": 0.0, "recal": 0.0, "fscore": 0.0}
    d1 = nn_distances(pts_pred, pts_trgt)  # the host library's KD-tree; no fallback
    d2 = nn_distances(pts_trgt, pts_pred)
    precision = float((d1 < threshold).mean())
    recall = float((d2 < threshold).mean())
    fscore = 2 * precision * recall / max(precision + recall, 1e-12)
    return {"dist1": float(d1.mean()), "dist2": float(d2.mean()), "prec": precision,
            "recal": recall, "fscore": float(fscore)}


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
