"""Tests that need a card (marker ``card``; they skip without one): each cell
at its own size through the benchmark's command (an 8 s window: enough
steps for the 95th percentile of the step times), and the comparison's
control at the cell's own size."""
import json
import os
import subprocess
import sys

import pytest

from benchlib import compare, registry
from reference import precision

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = registry.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name, card):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                        str(2 ** 31 + 11), "--seconds", "8", "--trace", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    cell = registry.cell(ROOT, BENCH, name)
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}
    for m, v in line["metrics"].items():
        if m.split(".")[0].endswith("_roofline") or "mfu" in m:
            assert 0 < v["value"] <= 100, (m, v)
    assert line["device"]["busy_s"] > 0 and line["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, card):
    cell = registry.cell(ROOT, BENCH, name)
    d = registry.driver(cell.driver)(cell.config, cell.traffic, 2 ** 31 + 12, card)
    d.start()
    d.free()
    ref = d.reference_readings()
    with precision.mode("tf32"):
        nums = compare.numbers(d.reference_readings(), ref, cell.loss_steps)
    assert not compare.verdict(nums, cell.limits), nums
