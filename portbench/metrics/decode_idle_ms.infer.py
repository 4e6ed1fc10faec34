"""Device idle time a reconstruct request, ms, while the host was decoding
the grid (train/predict.predict_tsdf_volume: the grid tables and K2): the
gaps between the traced window's merged device intervals under the
program's gennerf.decode span (the split: metrics/other_idle_ms.infer.py)."""
from portbench.core.spec import piece


def read(r):
    split = piece("metrics", "other_idle_ms.infer").idle_split(r)
    return None if split is None else split["gennerf.decode"]
