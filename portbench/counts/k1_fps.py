"""Operations and bytes of K1, farthest-point sampling of B clouds of N
points down to `npoint` (a frozen copy of the count chip_smoke.py uses).

ASSUMED, not derived from the kernel: 10 float32 operations per point per
iteration (three differences, three products, two sums, the running
minimum and the arg-max comparison). Bytes: each cloud read once, the
starts read and the picks written once."""
from portbench.core import peaks
from portbench.core.readers import roofline

OPS_PER_POINT_ITERATION = 10  # assumed


def flops(clouds: int, points: int, npoint: int) -> float:
    return float(OPS_PER_POINT_ITERATION * clouds * points * npoint)


def bytes_moved(clouds: int, points: int, npoint: int) -> float:
    return float(clouds * points * 3 * 4 + clouds * 4 + clouds * npoint * 4)


def share(r, launches):
    s = r.shapes
    args = (s["fps_clouds"], s["fps_points"], s["fps_npoint"])
    return roofline(r, launches, flops(*args), bytes_moved(*args), peaks.PEAK_F32)
