"""The run as its command starts it: no result without a card, no result from
a directory that holds only the benchmark, the last line's schema, the
checks as the last lines of standard error, and the import check by whole
top-level module names over everything a run loads."""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

import run as run_script
from benchlib import importcheck, registry, runner
from tinycells import ROOT, tiny

CELLS = ("head_3dgs.s1_1m", "strands_10k.s2_diffusion")
BENCH_CELLS = [w["name"] for w in registry.load_benchmark(ROOT)["workloads"]]
ENV = dict(os.environ, CUDA_VISIBLE_DEVICES="")


def _cli(cwd, *args):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd, env=ENV,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("name", BENCH_CELLS)
def test_no_card_fails_without_a_result(name):
    p = _cli(ROOT, "--workload", name, "--seed", str(2 ** 31 + 7), "--seconds", "1",
             "--trace", "0")
    assert p.returncode == 3 and p.stdout.strip() == "", (p.returncode, p.stdout, p.stderr)
    assert "torch.cuda.is_available() is false" in p.stderr


def test_a_held_out_cell_is_not_run():
    assert CELLS[0] not in BENCH_CELLS
    p = _cli(ROOT, "--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0")
    assert p.returncode == 1 and p.stdout.strip() == ""
    assert f"no workload {CELLS[0]!r} in BENCHMARK.json" in p.stderr


def test_only_the_benchmark_fails_without_a_result(tmp_path):
    shutil.copytree(registry.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = _cli(tmp_path, "--workload", BENCH_CELLS[0], "--seed", "1", "--seconds", "1",
             "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""
    d = registry.driver("stage1_step")
    cell = tiny(CELLS[0])
    drv = d(cell.config, cell.traffic, 1, "cpu")
    sys_path = list(sys.path)
    try:
        sys.path[:] = [x for x in sys.path if os.path.abspath(x) != ROOT]
        for mod in [m for m in sys.modules if m.split(".")[0] == "gaussianhaircut_torch"]:
            sys.modules[mod] = None
        with pytest.raises(ImportError):
            drv.start()
    finally:
        sys.path[:] = sys_path
        for mod in [m for m, v in sys.modules.items() if v is None]:
            del sys.modules[mod]


def test_import_check_compares_whole_top_level_names():
    mods = {"gaussianhaircut_torch": 1, "gaussianhaircut_torch.ops": 1, "jaxtyping": 1,
            "flaxen.x": 1, "numpy": 1}
    assert importcheck.forbidden_modules(mods) == []
    mods.update({"jax.numpy": 1, "gaussianhaircut_tpu.ops.rasterize": 1, "optax": 1})
    assert importcheck.forbidden_modules(mods) == ["gaussianhaircut_tpu", "jax", "optax"]


def test_a_run_loads_nothing_of_jax():
    """A whole tiny run in a fresh process, then every loaded module's
    top-level name against the forbidden ones."""
    code = ("import sys, json; sys.path[:0] = ['benchmark', '.'];"
            "from benchlib import runner, importcheck; from tinycells import tiny;"
            f"r, _ = runner.run('.', '{CELLS[1]}', 5, 0.2, True, 0.0, device='cpu',"
            f" require_chip=False, cell_override=tiny('{CELLS[1]}'));"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "gaussianhaircut_torch" in loaded
    assert not loaded & importcheck.FORBIDDEN


def test_sources_import_nothing_of_jax():
    for dirpath, _, files in os.walk(registry.HERE):
        for f in files:
            if f.endswith(".py"):
                tree = ast.parse(open(os.path.join(dirpath, f)).read())
                for node in ast.walk(tree):
                    names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                             [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                    for n in names:
                        assert n.split(".")[0] not in importcheck.FORBIDDEN, (f, n)


@pytest.mark.parametrize("trace", (0, 1))
def test_last_line_schema(trace, monkeypatch, capsys):
    cell = tiny(CELLS[0])
    real = runner.run
    monkeypatch.setattr(runner, "run", lambda root, w, seed, s, t, t0: real(
        root, w, seed, 0.3, t, t0, device="cpu", require_chip=False, cell_override=cell))
    assert run_script.main(["--workload", CELLS[0], "--seed", str(2 ** 33 + 1), "--seconds", "1",
                            "--trace", str(trace)]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[:5] == keys and list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool) and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    declared = {m["name"]: m["unit"] for m in (cell.per_layer if trace else cell.end_to_end)}
    for name, m in line["metrics"].items():
        assert declared[name] == m["unit"] and isinstance(m["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    else:
        assert set(line["metrics"]) == set(declared) and "breakdown" not in line
    checks = [x for x in err.strip().splitlines() if x.startswith("check ")]
    assert err.strip().splitlines()[-len(line["checks"]):] == checks
    for name, c in line["checks"].items():
        assert f"check {name} {c['value']!r} limit {c['limit']!r}" in err
