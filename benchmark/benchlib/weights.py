"""Network weights made from the seed on the run's device, in one draw per
kind of initialiser: ``specs`` lists (name, shape, init) with init one of
``lecun`` (flax's default kernel init: a normal truncated at two standard
deviations, scaled to variance 1 / fan_in, fan_in from the torch layout),
``normal:<std>``, ``zeros`` or ``ones``."""
from __future__ import annotations

import math

import torch


def _fan_in(shape) -> int:
    return int(shape[1] * math.prod(shape[2:]))


def make(specs, gen: torch.Generator) -> dict:
    dev = gen.device
    sizes = {name: math.prod(shape) for name, shape, _ in specs}
    lecun = [s for s in specs if s[2] == "lecun"]
    normal = [s for s in specs if s[2].startswith("normal:")]
    u = torch.rand(sum(sizes[n] for n, _, _ in lecun), generator=gen, device=dev,
                   dtype=torch.float64)
    z = torch.randn(sum(sizes[n] for n, _, _ in normal), generator=gen, device=dev)
    lo, hi = (1 + math.erf(-2.0 / 2 ** 0.5)) / 2, (1 + math.erf(2.0 / 2 ** 0.5)) / 2
    u = torch.clamp(torch.erfinv(2 * (lo + (hi - lo) * u) - 1) * 2 ** 0.5, -2.0, 2.0)
    out, iu, iz = {}, 0, 0
    for name, shape, init in specs:
        n = sizes[name]
        if init == "lecun":
            std = (1.0 / _fan_in(shape)) ** 0.5 / 0.87962566103423978
            out[name] = (u[iu:iu + n] * std).to(torch.float32).reshape(shape)
            iu += n
        elif init.startswith("normal:"):
            out[name] = (z[iz:iz + n] * float(init.split(":")[1])).reshape(shape)
            iz += n
        elif init in ("zeros", "ones"):
            out[name] = (torch.zeros if init == "zeros" else torch.ones)(shape, device=dev)
        else:
            raise ValueError(f"{name}: unknown initialiser {init!r}")
    return out
