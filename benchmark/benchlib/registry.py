"""Find everything a run needs by the names in ``BENCHMARK.json``.

- a cell ``<config>.<traffic>``: ``cells/<cell>.json`` (its driver, the
  traffic parameters, the limits of the comparison, ``chips`` and ``why``);
- a configuration: the file ``BENCHMARK.json`` names for it;
- a driver (one per step entry of the port): ``drivers/<driver>.py`` with a
  ``Driver`` class;
- a metric: ``metrics/<base>.py`` with ``read(record)``, where ``<base>`` is
  the metric's name up to its first dot (``step_ms_p95.s1`` is read by
  ``metrics/step_ms_p95.py``).

A later cell, configuration, driver or metric is a new file and a new entry
of ``BENCHMARK.json``; nothing here changes.

A cell held out of ``BENCHMARK.json`` keeps its entries in
``pending/<cell>.json`` (with the ``reason``): the benchmark's tests and
``calibrate.py`` read them, a run never does.  Copying the entries into
``BENCHMARK.json`` puts the cell in the benchmark; the pending file's
entries are then read from there alone.
"""
from __future__ import annotations

import dataclasses
import glob
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    driver: str
    chips: int
    limits: dict
    end_to_end: list      # the BENCHMARK.json metrics this cell reports
    per_layer: list
    loss_steps: tuple = (1, 2, 3)   # the steps whose losses the comparison reads


def load_benchmark(root: str, pending: bool = False) -> dict:
    """``BENCHMARK.json``; with ``pending``, and the held-out cells' entries."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    if pending:
        for path in sorted(glob.glob(os.path.join(HERE, "pending", "*.json"))):
            with open(path) as f:
                held = json.load(f)
            for key in ("configs", "workloads", "end_to_end", "per_layer"):
                have = {e["name"] for e in bench[key]}
                bench[key] = bench[key] + [e for e in held[key] if e["name"] not in have]
    return bench


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(root: str, bench: dict, name: str) -> Cell:
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "cells", f"{name}.json")) as f:
        spec = json.load(f)
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[key]:
            raise ValueError(f"cells/{name}.json: {key} {spec[key]!r} differs from "
                             f"BENCHMARK.json's {entry[key]!r}")
    return Cell(name, config, spec["params"], spec["driver"], entry["chips"], spec["limits"],
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)],
                tuple(spec.get("loss_steps", (1, 2, 3))))


def _module(kind: str, name: str):
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise KeyError(f"no {kind[:-1]} {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"_bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return _module("drivers", name).Driver


def reader(metric_name: str):
    return _module("metrics", metric_name.split(".")[0]).read
