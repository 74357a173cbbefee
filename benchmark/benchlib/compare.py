"""The comparison that decides ``correct`` for a training cell.

Both sides start from the same state and run the same first three steps
(the same cameras, the same draws).  Each side gives ``Readings``:

- ``loss``: the loss of each of the three steps;
- ``grad``: per leaf, the norm of the first step's gradient as the optimizer
  got it, worked out from the optimizer's state after that step (first
  moment / (1 - beta1));
- ``change``: per leaf, the norm of the state's change over the three steps;
- ``group``: per leaf, the group whose median leaf it is measured against
  (``param``: parameters and camera residuals; ``aux``: the densify
  statistics; ``ema``: the denoiser's EMA copy).

The numbers compared, each with a limit of its own:

- ``loss_gap``: the largest |loss - reference loss| / |reference loss| over
  the steps the cell compares (``loss_steps``: all three, or the first alone
  where the later steps' losses carry the noise of Adam's updates);
- ``grad_gap``: over the leaves, the largest gap between the two gradient
  norms, over the reference's norm of that leaf or of its group's median
  leaf, whichever is larger;
- ``change_gap``: the same for the change norms, leaving out the leaves
  whose reference gradient is under a thousandth of the median leaf's (Adam
  moves those by round-off alone).
"""
from __future__ import annotations

import dataclasses
import math
import statistics

EXCLUDE_BELOW = 1e-3
NUMBERS = ("loss_gap", "grad_gap", "change_gap")


@dataclasses.dataclass
class Readings:
    loss: list
    grad: dict
    change: dict
    group: dict


def _worst(a: dict, b: dict, group: dict, leaves) -> tuple[float, str]:
    medians = {}
    for g in set(group[k] for k in leaves):
        medians[g] = statistics.median(b[k] for k in leaves if group[k] == g)
    worst, at = 0.0, ""
    for k in leaves:
        den = max(b[k], medians[group[k]])
        gap = abs(a[k] - b[k]) / den if den > 0 else (0.0 if a[k] == 0 else math.inf)
        gap = math.inf if gap != gap else gap        # a NaN reading is the worst
        if gap > worst or not at:
            worst, at = gap, k
    return worst, at


def numbers(prog: Readings, ref: Readings, loss_steps=(1, 2, 3)) -> dict:
    """-> {name: (value, leaf or step)}."""
    loss = [(abs(a - b) / abs(b) if b != 0 else abs(a)) if k + 1 in loss_steps else 0.0
            for k, (a, b) in enumerate(zip(prog.loss, ref.loss))]
    loss_gap = max(loss) if all(x == x for x in loss) else math.inf
    grad_leaves = sorted(ref.grad)
    param = [k for k in grad_leaves if ref.group[k] == "param"]
    med = statistics.median(ref.grad[k] for k in param)
    excluded = {k for k in grad_leaves if ref.grad[k] < EXCLUDE_BELOW * med}
    change_leaves = sorted(k for k in ref.change if k not in excluded)
    grad = _worst(prog.grad, ref.grad, ref.group, grad_leaves)
    change = _worst(prog.change, ref.change, ref.group, change_leaves)
    return {"loss_gap": (loss_gap, f"step {loss.index(max(loss)) + 1}" if loss_gap < math.inf
                         else "nan"),
            "grad_gap": grad, "change_gap": change, "excluded": sorted(excluded)}


def verdict(nums: dict, limits: dict) -> bool:
    return all(nums[n][0] <= limits[n] for n in NUMBERS)
