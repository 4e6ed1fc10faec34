"""Operations and bytes of K2, the separable grid decode of an (nx, ny, nz)
grid through n_blocks residual blocks of width H (a frozen copy of
gennerf_tpu_torch/ops/grid_decode.grid_decode_flops and of chip_smoke.py's
byte count).

Operations: per voxel two H x H products per block and the head's H-long
dot (the tables' small products are done before the kernel). Bytes: every
table and packed weight read once (float32 tables; bf16 weight slabs and
head), the float32 volume written once."""
import math


def flops(grid, H: int, n_blocks: int) -> float:
    return float(math.prod(grid) * (n_blocks * 2 * 2 * H * H + 2 * H))


def bytes_moved(grid, H: int, n_blocks: int) -> float:
    nx, ny, nz = grid
    tables = (ny * nz + nx * nz + nx * ny + n_blocks * (nx + ny + nz)) * H * 4
    weights = 2 * n_blocks * H * H * 2 + 2 * n_blocks * H * 4 + H * 2
    return float(tables + weights + nx * ny * nz * 4)
