"""The comparison that decides `correct` fails what it must: the control
(the reference one precision below the configuration's, fp8 for bf16, in
the program's place) and each fault a cell can have, planted under the
timed path of a whole CPU run (the look for a card skipped)."""
import pytest

from portbench import run
from portbench.core import faults
from portbench.tests.tiny import cpu_ctx


def _failed(checks: dict) -> list:
    return [k for k, c in checks.items() if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("cell", ["gennerf_living.recon", "gennerf_living.train",
                                  "voxelnet_living.train"])
def test_control_fails(cell):
    ctx = cpu_ctx(cell, seed=2**32 + 3)
    d = ctx.driver
    st = d.prepare(ctx)
    evidence = d.control(ctx, st)
    d.release(st)
    checks = run.judge_checks(d.judge(ctx, st, evidence)["checks"], ctx.limits)
    assert _failed(checks), checks


@pytest.mark.parametrize("cell,fault", [
    ("gennerf_living.recon", "answer_altered"),
    ("gennerf_living.train", "state_unchanged"),
    ("gennerf_living.train", "half_batch"),
    ("voxelnet_living.train", "state_unchanged"),
    ("voxelnet_living.train", "half_batch"),
])
def test_fault_makes_the_run_incorrect(cell, fault):
    ctx = cpu_ctx(cell, seed=2**34 + 5)
    with faults.planted(fault):
        res = run.run_cell(ctx)
    assert not res["correct"], res["checks"]
