#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the cards the cell needs.
Prints one JSON object as the last line of standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the comparison compared,
beside its limit) and the same checks as the last lines of standard error.
Without a card, or with fewer than the cell asks for, it exits with 3 and
prints no result; on any other failure, with 1.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(1, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from benchlib import runner
    try:
        result, _ = runner.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                               T_START)
    except runner.NoChip as e:
        print(f"no run: {e}", file=sys.stderr)
        return 3
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps(result), flush=True)
    runner.print_checks(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
