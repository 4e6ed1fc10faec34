"""The share of the backprojection's (item, frame, voxel) pairs that some
pixel sees, %: the program's counters backproject.observed over
backproject.pairs (ops/projection.backproject_fold, once per frame chunk;
a recompute under remat counts both again), counted over the traced window.

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
    pairs, observed = c.get("backproject.pairs"), c.get("backproject.observed")
    if not pairs or observed is None:
        return None
    return 100.0 * observed / pairs
