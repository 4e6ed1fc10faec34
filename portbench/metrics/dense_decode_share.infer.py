"""The share of a reconstruct's decoded points that the chunked per-point
decode (train/predict.decode_dense) took, off the grid-decode kernel, %:
the program's counters decode.dense_points over decode.dense_points plus
decode.voxels (ops/grid_decode, K2), counted over the traced window. 100
where every scene carries a feature volume, which keeps it off K2.

Reads the program's counters (gennerf_tpu_torch/utils/spans.py) as
k2_kept_share.infer.py does. None where the program has no such module or
counted neither."""


def read(r):
    try:
        from gennerf_tpu_torch.utils import spans
    except ImportError:
        return None
    c = spans.counters()
    dense, grid = c.get("decode.dense_points", 0.0), c.get("decode.voxels", 0.0)
    if not dense + grid:
        return None
    return 100.0 * dense / (dense + grid)
