"""The program's named spans and counters, on the profiler's clock.

While a torch profiler records on the calling thread, `span(name)` is
`torch.profiler.record_function(name)`: the span lands in the profiler's
trace beside the device's kernels, on the same clock, so a reader can put
each idle gap of the device down to the stage the host was in. `count`
adds to a named counter then. With no profiler recording, both do nothing
beyond one check of the profiler's flag (on a CPU host an unguarded
record_function costs ~13 us a call, the check ~0.1 us). Counts cover
exactly the profiled windows of the process.

Spans (where):
    gennerf.reconstruct   predict.reconstruct
    gennerf.encode        GenNerf.encode, VoxelNet.encode
    gennerf.featurize     GenNerf.features_2d (the spatial encoder, the teacher)
    gennerf.backproject   ops/projection.backproject_fold
    gennerf.volume        GenNerf.volume_features (the count-normalised volume)
    gennerf.decode        train/predict.predict_tsdf_volume(_sparse)
    gennerf.prior         tsdf/fusion.apply_fusion_prior
    gennerf.refine        VoxelNet.refine (the 3D net and the heads)
    gennerf.step          train/step.train_step, and inside it
    gennerf.forward, gennerf.backward, gennerf.allreduce, gennerf.optimizer

Counters (where: value):
    decode.voxels         ops/grid_decode.grid_decode: voxels decoded
    decode.dense_points   train/predict.decode_dense: points decoded off the kernels
    prior.kept_voxels     tsdf/fusion.apply_fusion_prior: voxels in the band
    backproject.pairs     ops/projection.backproject_fold: (item, frame, voxel) pairs
    backproject.kernel_pairs  the same, those the kernel (csrc/backproject.cu) took
    backproject.observed  ops/projection.backproject_fold: those some pixel sees
    lift.pixels           models/spatial_encoder.SpatialEncoder.forward: output pixels
    lift.fused_pixels     the same, where the fused lift (ops/spatial_lift) ran
    volume.voxels         GenNerf.volume_features: voxels of each normalised volume
    volume.observed_voxels  the same, those some frame sees (count above 0)
    trilinear.points      ops/interpolation.trilinear_interpolation: points sampled
    trilinear.kernel_points  the same, those the kernel (csrc/volume_sample.cu) sampled
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Union

import torch

_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_counts: Dict[str, List[Union[int, torch.Tensor]]] = defaultdict(list)


def span(name: str):
    """A context manager: the profiler's range `name` while a profiler
    records on this thread, else a shared no-op."""
    if _recording():
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, value: Union[int, torch.Tensor]) -> None:
    """Add `value` to counter `name` while a profiler records: a host int,
    or the sum of a tensor (one reduction on its device, kept there and
    read only by `counters`)."""
    if not _recording():
        return
    _counts[name].append(value.detach().sum(dtype=torch.float64)
                         if isinstance(value, torch.Tensor) else int(value))


def counters() -> Dict[str, float]:
    """{name: the sum of everything counted so far}; reading a device
    value waits for it, so the caller synchronises first."""
    out = {}
    for name, values in _counts.items():
        total, by_device = 0.0, defaultdict(list)
        for v in values:
            if isinstance(v, torch.Tensor):
                by_device[v.device].append(v)
            else:
                total += v
        out[name] = total + sum(float(torch.stack(vs).sum()) for vs in by_device.values())
    return out


def reset() -> None:
    """Forget every count."""
    _counts.clear()
