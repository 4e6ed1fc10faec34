"""Device kernels in the traced window per training step (copies and
fills left out; on more than one chip, the traced rank's)."""


def read(r):
    if not r.trace or not r.trace["kernels"] or not r.work["steps"]:
        return None
    return len(r.trace["kernels"]) / r.work["steps"]
