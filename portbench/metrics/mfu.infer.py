"""The reconstruct requests' model FLOPs (counts/<config>.request_flops)
over the window and the bf16 dense peak, %."""
from portbench.core.readers import mfu


def read(r):
    return mfu(r, r.counts.request_flops(r.cfg), r.work["requests"])
