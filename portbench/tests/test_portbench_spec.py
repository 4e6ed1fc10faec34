"""BENCHMARK.json against the contract's characters and shape, and every
piece it names found by name."""
import json
import os
import re

import pytest

from portbench.core import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
BENCH = spec.load_benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert all(LINE.match(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    assert all(re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.startswith("/")
               and ".." not in p for p in BENCH["paths"])
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert LINE.match(e[key]), (e["name"], key)


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_enough_and_finds_its_pieces():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        cell = w["name"]
        ends = [m["name"] for m in spec.cell_metrics(BENCH, cell, "end_to_end")]
        layers = spec.cell_metrics(BENCH, cell, "per_layer")
        assert "setup_s" in ends and len(ends) >= 2 and layers
        for m in layers:
            assert m["moves"] in ends
            spec.piece("metrics", m["name"])
        tr = spec.traffic(w["traffic"])
        spec.piece("drivers", tr["driver"])
        spec.piece("reference", w["config"])
        spec.piece("counts", w["config"])
        assert spec.limits(cell)["checks"]
        assert spec.config(BENCH, w["config"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}


def test_config_files_are_distinct_and_state_their_cut():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["reduced"] == c["reduced"] and body["assumed"] and body["deployment"]
