"""Reduction of ``torch.profiler`` traces: device events, their union, the
idle gaps between them and the host operation that spanned each gap.

Times are microseconds on the profiler's clock, which the device events
share with the host events."""
from __future__ import annotations

import bisect
import collections

import torch


def _events(prof, device: bool) -> list:
    want = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    out = []
    for e in prof.events():
        if e.device_type == want:
            out.append((e.name, float(e.time_range.start), float(e.time_range.end)))
    return out


def device_events(prof) -> list:
    """(name, start, end) of every kernel, memcpy and memset on the device."""
    return _events(prof, True)


def host_events(prof) -> list:
    """(name, start, end) of every host operation and runtime call."""
    return _events(prof, False)


def union(events) -> list:
    """Merged [start, end] intervals covered by ``events``."""
    merged = []
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_us(events) -> float:
    return sum(e - s for s, e in union(events))


def by_name(events) -> list:
    """[(name, total us)] by descending total."""
    tot = collections.defaultdict(float)
    for n, s, e in events:
        tot[n] += e - s
    return sorted(tot.items(), key=lambda kv: -kv[1])


def idle_gaps(dev_events, host, longest: int = 2000, scan: int = 20000) -> list:
    """[(host operation, idle us)] by descending total over the ``longest``
    gaps between the device's busy intervals: each named after the innermost
    host event spanning the gap's midpoint (the latest to start among the
    ``scan`` before it), or ``python`` where none does."""
    merged = union(dev_events)
    gaps = sorted(((s1 - e0, 0.5 * (e0 + s1)) for (_, e0), (s1, _) in zip(merged[:-1], merged[1:])),
                  reverse=True)[:longest]
    host = sorted(host, key=lambda x: x[1])
    starts = [h[1] for h in host]
    tot = collections.defaultdict(float)
    for dur, mid in gaps:
        name = "python"
        i0 = bisect.bisect_right(starts, mid) - 1
        for j in range(i0, max(-1, i0 - scan), -1):
            if host[j][2] >= mid:
                name = host[j][0]
                break
        tot[name] += dur
    return sorted(tot.items(), key=lambda kv: -kv[1])
