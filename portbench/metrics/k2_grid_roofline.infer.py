"""K2, the grid decode (csrc/grid_decode.cu): its roofline bound
(counts/k2_grid.py, bf16 tensor-core peak) over its traced device time, %."""
from portbench.core import peaks
from portbench.core.readers import kernels_named, roofline
from portbench.core.spec import piece


def read(r):
    k2 = piece("counts", "k2_grid")
    mlp = r.cfg["model"]["mlp"]
    grid = r.shapes["grid"]
    return roofline(r, kernels_named(r, "grid_decode"),
                    k2.flops(grid, mlp["d_hidden"], mlp["n_blocks"]),
                    k2.bytes_moved(grid, mlp["d_hidden"], mlp["n_blocks"]), peaks.PEAK_BF16)
