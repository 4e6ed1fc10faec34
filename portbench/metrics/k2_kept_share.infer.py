"""The share of K2's decoded voxels that the fusion prior keeps, %: the
program's counters prior.kept_voxels (the near-surface band of
tsdf/fusion.apply_fusion_prior) over decode.voxels (ops/grid_decode), both
counted over the traced window.

Imports the program's span module (gennerf_tpu_torch/utils/spans.py) to
read its counters: the benchmark's only contact with the program outside
core/port.py, and read-only. None where the program has no such module or
counted nothing."""


def read(r):
    try:
        from gennerf_tpu_torch.utils import spans
    except ImportError:
        return None
    c = spans.counters()
    voxels, kept = c.get("decode.voxels"), c.get("prior.kept_voxels")
    if not voxels or kept is None:
        return None
    return 100.0 * kept / voxels
