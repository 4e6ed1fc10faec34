"""Device idle time a reconstruct request, ms, while the host was in none
of the program's three stages: input conversion in predict.reconstruct,
the host copy, the client loop. Also holds the split the stage metrics
read (`idle_split`).

The idle time is the gaps between the traced window's merged device
intervals (the union core/trace.union_seconds takes); each instant of a
gap goes to the first stage whose span, gennerf.encode, gennerf.decode or
gennerf.prior (the program's gennerf_tpu_torch/utils/spans.py, in the
trace's host events), covers it, else to the rest. The four parts, times
the requests, sum to the gaps. None without a trace, a request or the
program's gennerf.reconstruct span (a program without spans)."""
from typing import Dict, List, Optional, Tuple

from portbench.core.trace import union_seconds

STAGES = ("gennerf.encode", "gennerf.decode", "gennerf.prior")


def _overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_split(r) -> Optional[Dict[str, float]]:
    """{stage: idle ms a request, 'other': the rest} of the traced window."""
    if not r.trace or not r.trace["device_ops"] or not r.work.get("requests"):
        return None
    cpu = r.trace["cpu"]
    if not any(name == "gennerf.reconstruct" for name, _, _ in cpu):
        return None
    _, busy = union_seconds([(s, s + d) for _, s, d in r.trace["device_ops"]])
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    total = sum(e - s for s, e in gaps)
    out, covered, spans = {}, 0.0, []
    for stage in STAGES:
        spans += [(s, e) for name, s, e in cpu if name == stage]
        so_far = _overlap(gaps, union_seconds(spans)[1])
        out[stage] = so_far - covered
        covered = so_far
    out["other"] = total - covered
    per_request = 1e3 / r.work["requests"]
    return {k: v * per_request for k, v in out.items()}


def read(r):
    split = idle_split(r)
    return None if split is None else split["other"]
