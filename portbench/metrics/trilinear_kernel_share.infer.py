"""The share of the trilinear volume samples' points that the hand-written
kernel took, %: the program's counters trilinear.kernel_points over
trilinear.points (ops/interpolation.trilinear_interpolation, every call),
counted over the traced window. 100 where every sample of a reconstruct
runs on the card without an autograd graph.

Reads the program's counters (gennerf_tpu_torch/utils/spans.py) as
lift_fused_share.train.py does. None where the program has no such module
or counted no sample."""


def read(r):
    try:
        from gennerf_tpu_torch.utils import spans
    except ImportError:
        return None
    c = spans.counters()
    points, kernel = c.get("trilinear.points"), c.get("trilinear.kernel_points")
    if not points or kernel is None:
        return None
    return 100.0 * kernel / points
