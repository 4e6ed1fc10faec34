"""Device idle time a reconstruct request, ms, while the host was applying
the fusion prior (tsdf/fusion.apply_fusion_prior): the gaps between the
traced window's merged device intervals under the program's gennerf.prior
span (the split: metrics/other_idle_ms.infer.py)."""
from portbench.core.spec import piece


def read(r):
    split = piece("metrics", "other_idle_ms.infer").idle_split(r)
    return None if split is None else split["gennerf.prior"]
