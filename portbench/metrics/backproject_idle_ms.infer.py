"""Device idle time a reconstruct request, ms, while the host was in the
backprojection (ops/projection.backproject_fold, the frame loop that sums
the feature volume): the gaps between the traced window's merged device
intervals that lie under the program's gennerf.backproject span (the
helpers of metrics/other_idle_ms.infer.py). None without a trace, a
request or the span (a program without it)."""
from portbench.core.spec import piece
from portbench.core.trace import union_seconds


def read(r):
    if not r.trace or not r.trace["device_ops"] or not r.work.get("requests"):
        return None
    spans = [(s, e) for name, s, e in r.trace["cpu"] if name == "gennerf.backproject"]
    if not spans:
        return None
    _, busy = union_seconds([(s, s + d) for _, s, d in r.trace["device_ops"]])
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    idle = piece("metrics", "other_idle_ms.infer")._overlap(gaps, union_seconds(spans)[1])
    return idle * 1e3 / r.work["requests"]
