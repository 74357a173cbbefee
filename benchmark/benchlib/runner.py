"""One run of one cell: set-up, the measured window, the traced
sub-windows, the comparison that decides ``correct``, and the result.

The run, in order:

1. set-up (``setup_s``, from the process's start): inputs and weights from
   the seed, the port's state, the three checked steps through the window's
   own call (their readings kept), ``warmup_steps`` more, a synchronise;
2. the window: steps until ``--seconds`` have passed, then a synchronise;
   the rate is every step over the whole window; the device's peak memory
   over the window;
3. with ``--trace 1``, after the window: sub-window A (``trace_steps``
   steps under a profile of CUDA activity only: busy and idle time,
   launches, device operations by name), sub-window B (``gap_steps`` steps
   under a CPU and CUDA profile: what the host did in the device's idle
   gaps), then ``roofline_steps`` steps each profiled alone (CUDA only)
   after a snapshot of its state, whose kernels' times meet the work the
   benchmark counts on the snapshots;
4. the port's state freed, the reference's three steps, the comparison
   with its limits, the import check.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import torch

from benchlib import compare, importcheck, peaks, registry, roofline
from benchlib import trace as tr
from reference import precision


class NoChip(RuntimeError):
    pass


@dataclasses.dataclass
class Record:
    """What a run measured; the metric readers take their numbers from it."""
    setup_s: float = 0.0
    steps: int = 0
    views: int = 0
    seconds: float = 0.0
    step_s: list = dataclasses.field(default_factory=list)
    num_rendered: list = dataclasses.field(default_factory=list)
    views_per_step: int = 1
    peak_bytes: int = 0
    device_name: str = ""
    traced: dict = dataclasses.field(default_factory=dict)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profile(device, host: bool):
    acts = [torch.profiler.ProfilerActivity.CUDA] if device.type == "cuda" else []
    if host or not acts:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    return torch.profiler.profile(activities=acts)


def _traced(driver, device, traffic: dict) -> dict:
    out = {}
    n = traffic["trace_steps"]
    with _profile(device, host=False) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            driver.step()
        _sync(device)
        wall = time.perf_counter() - t0
    dev = tr.device_events(prof)
    out["a"] = {"steps": n, "wall_s": wall, "busy_s": tr.busy_us(dev) * 1e-6,
                "events": len(dev), "by_name": tr.by_name(dev)}
    with _profile(device, host=True) as prof:
        for _ in range(traffic["gap_steps"]):
            driver.step()
        _sync(device)
    out["b"] = {"gaps": tr.idle_gaps(tr.device_events(prof), tr.host_events(prof))}
    out["d"] = []
    for _ in range(traffic["roofline_steps"]):
        snap = driver.snapshot()
        _sync(device)
        with _profile(device, host=False) as prof:
            driver.step()
            _sync(device)
        dev = tr.device_events(prof)
        kernels = dict(tr.by_name(dev))
        out["d"].append({"snap": {k: (v.cpu() if torch.is_tensor(v) else
                                      {kk: vv.cpu() for kk, vv in v.items()}
                                      if isinstance(v, dict) else v) for k, v in snap.items()},
                         "busy_s": tr.busy_us(dev) * 1e-6,
                         "kernel_s": {k: v * 1e-6 for k, v in kernels.items()}})
    return out


def run(root: str, workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        device=None, require_chip: bool = True, cell_override=None) -> tuple[dict, bool]:
    """-> (the result's JSON object, whether the comparison passed)."""
    bench = registry.load_benchmark(root)
    cell = cell_override or registry.cell(root, bench, workload)
    if require_chip:
        if not torch.cuda.is_available():
            raise NoChip("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell.chips:
            raise NoChip(f"{torch.cuda.device_count()} cards, the cell needs {cell.chips}")
        device = torch.device("cuda", 0)
    device = torch.device(device or "cuda")
    on_card = device.type == "cuda"
    rec = Record(device_name=torch.cuda.get_device_name(device) if on_card else "cpu")
    marks = [("imports and card", time.perf_counter())]

    driver = registry.driver(cell.driver)(cell.config, cell.traffic, seed, device)
    _sync(device)
    marks.append(("inputs", time.perf_counter()))
    driver.start()
    _sync(device)
    marks.append(("state and checked steps", time.perf_counter()))
    for _ in range(cell.traffic["warmup_steps"]):
        driver.step()
    _sync(device)
    marks.append(("warm-up steps", time.perf_counter()))
    rec.setup_s = marks[-1][1] - t_start
    _log("set-up: " + ", ".join(f"{name} {t - t0:.2f} s" for (name, t), t0 in
                                zip(marks, [t_start] + [t for _, t in marks[:-1]])))
    rec.views_per_step = driver.views_per_step
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    losses = []
    t0 = time.perf_counter()
    last = t0
    while last - t0 < seconds:
        views, n_rendered, loss = driver.step()
        now = time.perf_counter()
        rec.step_s.append(now - last)
        rec.num_rendered.append(n_rendered)
        rec.views += views
        losses.append(loss)
        last = now
    _sync(device)
    rec.seconds = time.perf_counter() - t0
    rec.steps = len(losses)
    rec.peak_bytes = torch.cuda.max_memory_allocated(device) if on_card else 0
    memory_peak = max(setup_peak, rec.peak_bytes)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())

    _log(f"set-up {rec.setup_s:.2f} s; window {rec.steps} steps in {rec.seconds:.3f} s")
    if trace:
        t = time.perf_counter()
        rec.traced = _traced(driver, device, cell.traffic)
        _log(f"traced sub-windows {time.perf_counter() - t:.2f} s")
    driver.free()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    with precision.mode("float32"):
        nums = compare.numbers(driver.program_readings, driver.reference_readings(),
                               cell.loss_steps)
    if trace:
        rec.traced["work"] = [driver.step_work(d["snap"]) for d in rec.traced["d"]]
    _log(f"reference and counts {time.perf_counter() - t:.2f} s")
    peak = peaks.peak(rec.device_name)
    if trace and peak:
        w = rec.traced["work"][0]
        _log(f"first roofline step: {w['pairs']} blended pairs, {w['gaussians_blended']} "
             f"Gaussians blended, {w['instances']} instances (3-sigma rect); bound by "
             f"{roofline.bound_by(rec, peak, 'raster_fwd')} (forward), "
             f"{roofline.bound_by(rec, peak, 'raster_bwd')} (backward)")
    correct = compare.verdict(nums, cell.limits) and failed == 0

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = registry.reader(m["name"])(rec, peak)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": rec.steps, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu", "kind": rec.device_name,
                         "count": 1, "memory_peak_bytes": int(memory_peak)}}
    if trace:
        a = rec.traced["a"]
        result["device"].update(busy_s=a["busy_s"], window_s=a["wall_s"])
        result["breakdown"] = {
            "device_ops": [[n[:160], us * 1e-6] for n, us in a["by_name"][:10]],
            "idle_gaps": [[n[:160], us * 1e-6] for n, us in rec.traced["b"]["gaps"][:10]]}
    result["checks"] = {n: {"value": nums[n][0], "limit": cell.limits[n], "at": nums[n][1]}
                        for n in compare.NUMBERS}
    result["checks"]["failed_steps"] = {"value": failed, "limit": 0}
    found = importcheck.forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package were loaded: {found}")
    return result, correct


def _log(msg: str) -> None:
    print(f"[benchmark] {msg}", file=sys.stderr, flush=True)


def print_checks(result: dict) -> None:
    """Each number compared beside its limit, as the last lines of stderr."""
    for name, c in result["checks"].items():
        at = f" ({c['at']})" if c.get("at") else ""
        print(f"check {name} {c['value']!r} limit {c['limit']!r}{at}", file=sys.stderr)
