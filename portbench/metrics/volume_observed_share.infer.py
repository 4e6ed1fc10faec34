"""The share of the feature volume's voxels that some frame sees, %: the
program's counters volume.observed_voxels (a count above 0) over
volume.voxels, both counted in GenNerf.volume_features over the traced
window. The rest of the volume is summed, normalised and sampled as zeros.

Reads the program's counters (gennerf_tpu_torch/utils/spans.py) as
k2_kept_share.infer.py does. None where the program has no such module or
counted nothing."""


def read(r):
    try:
        from gennerf_tpu_torch.utils import spans
    except ImportError:
        return None
    c = spans.counters()
    voxels, observed = c.get("volume.voxels"), c.get("volume.observed_voxels")
    if not voxels or observed is None:
        return None
    return 100.0 * observed / voxels
