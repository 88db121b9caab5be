"""Finds what a cell names: its configuration, traffic mix and metrics.

Everything is found by the name ``BENCHMARK.json`` gives it, so that a new
configuration, traffic mix or metric is a new file and no edit:

* a configuration's ``file`` (a JSON object of sizes) names its ``app``,
  the module ``lightning_bench/configs/<app>.py`` that holds the
  application as a user writes it, beside its plain reference
  ``lightning_bench/reference/<app>.py``;
* a traffic mix is ``lightning_bench/traffic/<traffic>.json``;
* a metric is ``lightning_bench/metrics/<name>.py``, whose ``read`` takes a
  ``Readings`` and returns a number or None.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os

PACKAGE = "lightning_bench"
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with what it names, loaded."""

    name: str
    chips: int
    config: dict  # the configuration's file
    traffic: dict
    app: object  # lightning_bench.configs.<app>
    reference: object  # lightning_bench.reference.<app>
    end_to_end: list  # metric entries that this cell reports
    per_layer: list


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def module(kind: str, name: str):
    return importlib.import_module(f"{PACKAGE}.{kind}.{name}")


def traffic(name: str) -> dict:
    return load_json(os.path.join(HERE, "traffic", f"{name}.json"))


def metric(name: str):
    return module("metrics", name)


def applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def cell(root: str, workload: str) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json``."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(os.path.join(root, conf["file"]))
    return Cell(
        name=workload, chips=int(entry["chips"]), config=config,
        traffic=traffic(entry["traffic"]),
        app=module("configs", config["app"]),
        reference=module("reference", config["app"]),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if applies(m, workload)])
