"""Each plain reference agrees with the program at tiny sizes on the CPU:
the program run in float32 (its bf16 policy off) gives the reference's
answers to float32 rounding."""
import pytest
import torch

from portbench import run
from portbench.tests.tiny import cpu_ctx


@pytest.mark.parametrize("cell,compared,limits", [
    ("gennerf_living.recon", 0,
     {"band_rel_rms_gap": 1e-5, "prior_mismatches": 0, "fps_bad_picks": 0}),
    ("gennerf_living.train", 3,
     {"loss_rel_gap": 1e-5, "grad_norm_gap": 1e-3, "change_norm_gap": 1e-3, "fps_bad_picks": 0}),
    # one step: Adam's first step is lr * sign(g), and the signs of the
    # near-zero gradient entries that float32 rounding flips make later steps
    # part at this tiny size (BatchNorm and lr 1e-3)
    ("voxelnet_living.train", 1,
     {"loss_rel_gap": 1e-5, "grad_norm_gap": 1e-3, "change_norm_gap": 1e-3,
      "stats_change_gap": 1e-3}),
])
def test_reference_agrees_with_the_program_in_float32(cell, compared, limits):
    torch.manual_seed(0)
    ctx = cpu_ctx(cell, seed=2**33 + 17)
    ctx.cfg["precision"] = "32-true"
    if compared:
        ctx.traffic["compared"] = compared
    ctx.limits = {"checks": limits}
    res = run.run_cell(ctx)
    assert res["correct"], res["checks"]
