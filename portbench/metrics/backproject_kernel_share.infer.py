"""The share of the backprojection's (item, frame, voxel) pairs that the
hand-written kernel took, %: the program's counters
backproject.kernel_pairs over backproject.pairs
(ops/projection.backproject_fold, every call), counted over the traced
window. 100 where every backprojection of a reconstruct runs on the card
without an autograd graph.

Reads the program's counters (gennerf_tpu_torch/utils/spans.py) as
trilinear_kernel_share.infer.py does. None where the program has no such
module, counted no backprojection, or has no backproject.kernel_pairs
counter (a program without the kernel)."""


def read(r):
    try:
        from gennerf_tpu_torch.utils import spans
    except ImportError:
        return None
    c = spans.counters()
    pairs, kernel = c.get("backproject.pairs"), c.get("backproject.kernel_pairs")
    if not pairs or kernel is None:
        return None
    return 100.0 * kernel / pairs
