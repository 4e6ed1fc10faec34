"""The training steps' model FLOPs, forward and backward without recompute
(counts/<config>.step_flops, one chip's batch), over the window and the
bf16 dense peak of the chips, %."""
from portbench.core.readers import mfu


def read(r):
    return mfu(r, r.counts.step_flops(r.cfg) * r.chips, r.work["steps"])
