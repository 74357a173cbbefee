"""Discovery of configurations, cells, drivers and metric readers by the
names in ``BENCHMARK.json``, and the file's own rules."""
import json
import os
import re
import shutil

import pytest

from benchlib import registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = registry.load_benchmark(ROOT)
# with the held-out cells' entries (``pending/``): they keep the same rules
BENCH_ALL = registry.load_benchmark(ROOT, pending=True)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH_ALL["end_to_end"] + BENCH_ALL["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("w", BENCH_ALL["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(w):
    cell = registry.cell(ROOT, BENCH_ALL, w["name"])
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    assert cell.chips == w["chips"] == 1
    assert registry.driver(cell.driver).__name__ == "Driver"
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    assert set(cell.limits) == {"loss_gap", "grad_gap", "change_gap"}
    with open(os.path.join(registry.HERE, "cells", f"{w['name']}.json")) as f:
        assert json.load(f)["why"] == w["why"]


@pytest.mark.parametrize("c", BENCH_ALL["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
    with open(os.path.join(ROOT, c["file"])) as f:
        conf = json.load(f)
    assert conf["name"] == c["name"] and conf["source"] == c["source"]
    assert conf["reduced"] == c["reduced"] and "assumed" in conf
    assert any(w["config"] == c["name"] for w in BENCH_ALL["workloads"])


def test_population_holds_its_scale_cap():
    """No axis of a drawn Gaussian passes the configuration's ``max_scale``,
    and the draw below the cap is the uncapped one."""
    import math

    import torch

    from benchlib import inputs
    with open(os.path.join(ROOT, "benchmark/configs/head_3dgs.json")) as f:
        g = json.load(f)["gaussians"]
    capped = inputs.gaussians(inputs.generator(5, "gaussians", "cpu"), 20_000, g)
    free = inputs.gaussians(inputs.generator(5, "gaussians", "cpu"), 20_000,
                            {k: v for k, v in g.items() if k != "max_scale"})
    cap = math.log(g["max_scale"])
    assert float(capped["scaling"].max()) <= cap
    below = free["scaling"] < cap
    assert bool(below.any()) and bool((~below).any())
    assert torch.equal(capped["scaling"][below], free["scaling"][below])
    assert torch.equal(capped["xyz"], free["xyz"])


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_has_a_reader(m):
    assert callable(registry.reader(m["name"]))
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH_ALL["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("bench", (BENCH, BENCH_ALL), ids=("benchmark", "with_held_out"))
def test_names_and_rules(bench):
    for entry in bench["configs"] + bench["workloads"] + METRICS:
        assert NAME.match(entry["name"]), entry["name"]
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    by_name = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in by_name and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        moved = by_name[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in bench["workloads"]}
    assert len(cells) == len(bench["workloads"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    assert {c["name"] for c in bench["configs"]} == {w["config"] for w in bench["workloads"]}


def test_held_out_cells_are_whole():
    """Each pending file holds one cell with its reason, its configuration
    and the metrics that only it reports; where ``BENCHMARK.json`` has taken
    the cell in, its entries there are the pending file's."""
    pending = os.path.join(registry.HERE, "pending")
    files = sorted(f for f in os.listdir(pending) if f.endswith(".json"))
    assert files == ["head_3dgs.s1_1m.json"]
    for f in files:
        with open(os.path.join(pending, f)) as fh:
            held = json.load(fh)
        assert 1 <= len(held["reason"]) <= 200 and "\n" not in held["reason"]
        assert [w["name"] for w in held["workloads"]] == [f[:-len(".json")]]
        assert [c["name"] for c in held["configs"]] == [held["workloads"][0]["config"]]
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            for e in held[key]:
                taken = [x for x in BENCH[key] if x["name"] == e["name"]]
                assert taken in ([], [e])


def test_a_new_metric_is_a_file_and_an_entry(tmp_path, monkeypatch):
    """A later metric needs a reader file and a BENCHMARK.json entry, and no
    edit of a file already there."""
    shutil.copytree(registry.HERE, tmp_path / "benchmark")
    (tmp_path / "benchmark" / "metrics" / "steps_done.py").write_text(
        "def read(rec, peak):\n    return float(rec.steps)\n")
    bench = dict(BENCH)
    bench["per_layer"] = BENCH["per_layer"] + [{
        "name": "steps_done.strands", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "step loop", "moves": "strands_it_per_s",
        "workloads": ["strands_10k.s2_diffusion"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(registry, "HERE", str(tmp_path / "benchmark"))
    cell = registry.cell(str(tmp_path), registry.load_benchmark(str(tmp_path)),
                         "strands_10k.s2_diffusion")
    assert "steps_done.strands" in {m["name"] for m in cell.per_layer}
    assert registry.reader("steps_done.strands")(registry_record(steps=7), None) == 7.0


def registry_record(**kw):
    from benchlib.runner import Record
    return Record(**kw)
