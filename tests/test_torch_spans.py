"""The port's spans and counters (gennerf_tpu_torch/utils/spans.py) and the
benchmark's readers of them (portbench/metrics/*_idle_ms.infer.py,
k2_kept_share.infer.py, backproject_observed_share.train.py): off, a span
enters no profiler range and a counter keeps nothing; on, under a CPU
profiler, spans land in its events and counters sum; the idle split of a
fabricated trace sums to its gaps; a tiny traced run of each cell carries
the program's spans and both counter readers' numbers."""
import ast
import os
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gennerf_tpu_torch.utils import spans
from portbench import run
from portbench.core import spec
from portbench.core.readers import Reading
from portbench.tests.tiny import cpu_ctx

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPANS = {"gennerf.reconstruct", "gennerf.encode", "gennerf.decode", "gennerf.prior",
         "gennerf.refine", "gennerf.step", "gennerf.forward", "gennerf.backward",
         "gennerf.allreduce", "gennerf.optimizer", "gennerf.featurize", "gennerf.backproject",
         "gennerf.volume"}
COUNTERS = {"decode.voxels", "prior.kept_voxels", "backproject.pairs", "backproject.observed",
            "backproject.kernel_pairs", "lift.pixels", "lift.fused_pixels", "decode.dense_points",
            "volume.voxels", "volume.observed_voxels", "trilinear.points",
            "trilinear.kernel_points"}
IDLE = ("encode_idle_ms.infer", "decode_idle_ms.infer", "prior_idle_ms.infer",
        "other_idle_ms.infer")


@pytest.fixture(autouse=True)
def _fresh_counts():
    spans.reset()
    yield
    spans.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


# -- the module ----------------------------------------------------------------------

def test_span_off_enters_no_record_function(monkeypatch):
    def boom(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    first = spans.span("gennerf.encode")
    with first:
        with spans.span("gennerf.decode") as inner:
            assert inner is None
    assert spans.span("gennerf.prior") is first


def test_count_off_stores_nothing():
    spans.count("decode.voxels", 5)
    spans.count("prior.kept_voxels", torch.ones(4, dtype=torch.bool))
    assert spans.counters() == {}


def test_spans_on_land_nested_in_the_profiler_events():
    with _cpu_profile() as prof:
        with spans.span("gennerf.step"):
            with spans.span("gennerf.forward"):
                torch.mm(torch.ones(8, 8), torch.ones(8, 8))
            with spans.span("gennerf.backward"):
                torch.ones(3).sum()
    events = {e.name: e for e in prof.events() if e.name.startswith("gennerf.")}
    assert set(events) == {"gennerf.step", "gennerf.forward", "gennerf.backward"}
    outer = events["gennerf.step"].time_range
    for name in ("gennerf.forward", "gennerf.backward"):
        inner = events[name].time_range
        assert outer.start <= inner.start and inner.end <= outer.end, name
    mm = [e for e in prof.events() if e.name == "aten::mm"]
    assert mm and events["gennerf.forward"].time_range.start <= mm[0].time_range.start


def test_host_and_device_valued_counts_sum():
    with _cpu_profile():
        spans.count("backproject.pairs", 2)
        spans.count("backproject.pairs", 3)
        spans.count("backproject.pairs", torch.tensor([True, False, True]))
        spans.count("backproject.observed", torch.full((2, 3), 1.5))
        spans.count("backproject.observed", torch.tensor(4))
    spans.count("backproject.observed", 100)  # after the window: not counted
    assert spans.counters() == {"backproject.pairs": 7.0, "backproject.observed": 13.0}
    spans.reset()
    assert spans.counters() == {}


def _literals(call: str):
    found = set()
    pkg = os.path.join(REPO, "gennerf_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py") and f != "spans.py":
                with open(os.path.join(d, f)) as fh:
                    tree = ast.parse(fh.read())
                for node in ast.walk(tree):
                    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                            and node.func.id == call):
                        assert isinstance(node.args[0], ast.Constant), (f, node.lineno)
                        found.add(node.args[0].value)
    return found


def test_the_program_has_the_listed_spans_and_counters_alone():
    assert _literals("span") == SPANS
    assert _literals("count") == COUNTERS
    with open(os.path.join(REPO, "gennerf_tpu_torch", "utils", "spans.py")) as f:
        doc = f.read()
    for name in SPANS | COUNTERS:
        assert re.search(rf"\b{re.escape(name)}\b", doc), name


# -- the readers ---------------------------------------------------------------------

def _reading(device_ops, cpu, requests=2, trace=True):
    summary = {"device_ops": [(f"k{i}", s, e - s) for i, (s, e) in enumerate(device_ops)],
               "cpu": cpu} if trace else None
    return Reading({}, None, summary, 10.0, 1,
                   {"requests": requests, "steps": 0, "items": 0})


def _read(name, r):
    return spec.piece("metrics", name).read(r)


def test_idle_split_sums_to_the_gaps():
    # device busy [0, 1], [1.5, 3] and [2, 2.5] (merged), [5, 6]: gaps (1, 1.5), (3, 5)
    ops = [(0.0, 1.0), (1.5, 3.0), (2.0, 2.5), (5.0, 6.0)]
    cpu = [("gennerf.reconstruct", 0.0, 6.0), ("gennerf.encode", 0.5, 1.25),
           ("gennerf.decode", 3.0, 3.5), ("gennerf.decode", 3.25, 4.0),
           ("gennerf.prior", 4.5, 5.5), ("aten::copy_", 1.0, 5.0)]
    r = _reading(ops, cpu, requests=2)
    got = {name: _read(name, r) for name in IDLE}
    assert got == pytest.approx({"encode_idle_ms.infer": 125.0, "decode_idle_ms.infer": 500.0,
                                 "prior_idle_ms.infer": 250.0, "other_idle_ms.infer": 375.0})
    assert sum(got.values()) * 2 == pytest.approx(2500.0)


def test_a_gap_half_under_encode_splits_in_two():
    ops = [(0.0, 1.0), (3.0, 4.0)]
    cpu = [("gennerf.reconstruct", 0.0, 4.0), ("gennerf.encode", 0.5, 2.0)]
    r = _reading(ops, cpu, requests=1)
    assert _read("encode_idle_ms.infer", r) == pytest.approx(1000.0)
    assert _read("other_idle_ms.infer", r) == pytest.approx(1000.0)
    assert _read("decode_idle_ms.infer", r) == 0.0
    assert _read("prior_idle_ms.infer", r) == 0.0


@pytest.mark.parametrize("case", ["no_trace", "no_requests", "no_device_ops", "no_spans"])
def test_idle_readers_without_anything_to_read_give_none(case):
    ops = [] if case == "no_device_ops" else [(0.0, 1.0), (2.0, 3.0)]
    cpu = [] if case == "no_spans" else [("gennerf.reconstruct", 0.0, 3.0),
                                         ("gennerf.encode", 0.0, 3.0)]
    r = _reading(ops, cpu, requests=0 if case == "no_requests" else 1,
                 trace=case != "no_trace")
    for name in IDLE:
        assert _read(name, r) is None, name


def test_counter_readers():
    r = _reading([], [])
    assert _read("k2_kept_share.infer", r) is None
    assert _read("backproject_observed_share.train", r) is None
    with _cpu_profile():
        spans.count("decode.voxels", 400)
        spans.count("prior.kept_voxels", torch.arange(10) < 3)
        spans.count("decode.voxels", 400)
        spans.count("prior.kept_voxels", torch.ones(7, dtype=torch.bool))
        spans.count("backproject.pairs", 8)
        spans.count("backproject.observed", torch.tensor([[0.0, 2.0], [1.0, 3.0]]))
    assert _read("k2_kept_share.infer", r) == pytest.approx(100.0 * 10 / 800)
    assert _read("backproject_observed_share.train", r) == pytest.approx(75.0)


# -- a tiny traced run of each cell --------------------------------------------------

@pytest.mark.parametrize("cell, program_spans, metric", [
    ("gennerf_living.recon", {"gennerf.reconstruct", "gennerf.encode", "gennerf.decode",
                              "gennerf.prior"}, "k2_kept_share.infer"),
    ("voxelnet_living.train", {"gennerf.step", "gennerf.forward", "gennerf.encode",
                               "gennerf.refine", "gennerf.backward", "gennerf.allreduce",
                               "gennerf.optimizer"}, "backproject_observed_share.train"),
])
def test_tiny_traced_run_carries_the_program_spans_and_counters(cell, program_spans, metric):
    res = run.run_cell(cpu_ctx(cell, seconds=0.3, trace=True))
    names = {name for name, _, _ in res["summary"]["cpu"]}
    assert program_spans <= names, program_spans - names
    value = res["metrics"][metric]["value"]
    assert 0.0 < value <= 100.0
