#!/usr/bin/env python3
"""Readings that the limits of a cell's comparison are set from, in one
process (never run by a benchmark run).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,...,12 \\
        [--control-seeds 1,2,3] [--faults half_batch,altered_tile] [--out FILE]

For each seed: the port's three checked steps against the reference's
(the lower readings).  For each control seed: the reference computed with
TF32 operands in the port's place (the control, the precision below the
configurations' float32 with TF32 off), and each planted fault of
``faults.py`` in the port, against the same reference (the upper
readings).  A state left unchanged reads 1 by the measure and needs no run.
Prints one JSON object per reading and a summary: per number the largest
lower reading and the smallest upper reading of each kind.
"""
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(1, ROOT)

import argparse  # noqa: E402

import torch  # noqa: E402

import faults  # noqa: E402
from benchlib import compare, registry  # noqa: E402
from reference import precision  # noqa: E402


def _numbers(a, b, loss_steps=(1, 2, 3)) -> dict:
    """The numbers compared, with the losses and the five leaves of each
    norm whose two readings lie furthest apart (relative to their own)."""
    n = compare.numbers(a, b, loss_steps)
    out = {k: [n[k][0], n[k][1]] for k in compare.NUMBERS}
    out["losses"] = [a.loss, b.loss]
    for kind in ("grad", "change"):
        x, y = getattr(a, kind), getattr(b, kind)
        far = sorted(y, key=lambda k: -abs(x[k] - y[k]) / max(y[k], 1e-30))[:5]
        out[kind] = {k: [x[k], y[k]] for k in far}
    out["excluded"] = n["excluded"]
    return out


def calibrate(cell, seeds, control_seeds, fault_names, device, emit, witnesses=()) -> dict:
    lower, upper = [], {"control": [], **{f: [] for f in fault_names}}
    for seed in seeds:
        t = time.perf_counter()
        d = registry.driver(cell.driver)(cell.config, cell.traffic, seed, device)
        d.start()
        d.free()
        ref = d.reference_readings()
        lower.append(_numbers(d.program_readings, ref, cell.loss_steps))
        emit({"seed": seed, "kind": "program", **lower[-1], "s": time.perf_counter() - t})
        for w in witnesses:
            with faults.planted(w):
                wd = registry.driver(cell.driver)(cell.config, cell.traffic, seed, device)
                wd.start()
            wd.free()
            emit({"seed": seed, "kind": w, **_numbers(wd.program_readings, ref, cell.loss_steps)})
            del wd
        if seed in control_seeds:
            with precision.mode("tf32"):
                upper["control"].append(_numbers(d.reference_readings(), ref, cell.loss_steps))
            emit({"seed": seed, "kind": "control", **upper["control"][-1]})
            for f in fault_names:
                with faults.planted(f):
                    fd = registry.driver(cell.driver)(cell.config, cell.traffic, seed, device)
                    fd.start()
                fd.free()
                upper[f].append(_numbers(fd.program_readings, ref, cell.loss_steps))
                emit({"seed": seed, "kind": f, **upper[f][-1]})
                del fd
        del d
        if device.type == "cuda":
            torch.cuda.empty_cache()
    summary = {n: {"lower": max(x[n][0] for x in lower),
                   **{k: min(x[n][0] for x in v) for k, v in upper.items() if v}}
               for n in compare.NUMBERS}
    emit({"summary": summary})
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="half_batch,altered_tile")
    ap.add_argument("--witness", default="", help="another path of the port, e.g. rect3sigma")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    cell = registry.cell(ROOT, registry.load_benchmark(ROOT, pending=True), args.workload)
    ints = lambda s: [int(x) for x in s.split(",") if x]
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps({"workload": args.workload, **obj})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    emit({"device": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"})
    calibrate(cell, ints(args.seeds), set(ints(args.control_seeds)),
              [f for f in args.faults.split(",") if f],
              torch.device("cuda" if torch.cuda.is_available() else "cpu"), emit,
              [w for w in args.witness.split(",") if w])
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
