"""BENCHMARK.json against the benchmark's contract, and every name it
gives found by the harness."""

import json
import os
import re

import pytest

from lightning_bench.harness import bench
from lbench_cells import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "lightning_bench/run.py"]
    assert BENCH["paths"] == ["lightning_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name


def test_metrics():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert set(m) - {"workloads"} == METRIC_KEYS | (
            {"bound"} if m in BENCH["end_to_end"] else
            {"layer", "moves"}), m
        assert set(m.get("workloads", cells)) <= cells
        assert callable(bench.metric(m["name"]).read)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("lightning_bench/")
        conf = bench.load_json(os.path.join(ROOT, c["file"]))
        assert conf["reduced"] == c["reduced"]
        assert {"source", "assumed", "app"} <= set(conf)
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
        assert LINE.match(c["source"]) and LINE.match(c["why"])


def test_every_cell_is_found_and_reports_enough():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert NAME.match(w["traffic"])
        pairs.add((w["config"], w["traffic"]))
        cell = bench.cell(ROOT, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
        for fn in ("place", "run_app", "work", "judge", "control", "kept",
                   "launch_counters", "launches_per_app"):
            assert callable(getattr(cell.app, fn))
        assert set(cell.reference.LIMITS)
    assert len(pairs) == len(BENCH["workloads"])
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_names_of_files_under_paths():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "lightning_bench")):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            if "__pycache__" not in rel:
                assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
