"""The share of the spatial encoder's output pixels that went through the
fused lift, %: the program's counters lift.fused_pixels over lift.pixels
(models/spatial_encoder.SpatialEncoder.forward, every call; a recompute
under remat counts both again), counted over the traced window.

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
    pixels, fused = c.get("lift.pixels"), c.get("lift.fused_pixels")
    if not pixels or fused is None:
        return None
    return 100.0 * fused / pixels
