"""K1, farthest-point sampling (csrc/fps.cu), in a reconstruct cell: its
roofline bound (counts/k1_fps.py, float32 peak) over its traced device time, %."""
from portbench.core.readers import kernels_named
from portbench.core.spec import piece


def read(r):
    return piece("counts", "k1_fps").share(r, kernels_named(r, "fps_"))
