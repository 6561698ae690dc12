"""The benchmark's reading of the device trace.

``profile``: ``torch.profiler`` over a short steady sub-window; returns the
kernels' durations by name, the device's busy time (the union of every
device activity's interval), the sub-window's length, the device
operations that took most time, their count, and the longest idle gaps
named by the innermost host operation that spans each one, or, where none does, the
last one to end before it."""

from __future__ import annotations

import time

import torch


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(fn, n: int) -> dict:
    """Run ``fn()`` ``n`` times under the profiler, the last synchronized."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, host = [], []
    for ev in prof.events():
        span = (ev.time_range.start, ev.time_range.end)      # microseconds
        if ev.device_type == DeviceType.CUDA:
            dev.append((ev.name, span))
        elif ev.device_type == DeviceType.CPU:
            host.append((ev.name, span))
    kernels, by_name = {}, {}
    for name, (s, e) in dev:
        kernels.setdefault(name, []).append((e - s) * 1e-6)
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    busy = _merge([span for _, span in dev])
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (s + e)
        covering = [(he - hs, name) for name, (hs, he) in host if hs <= mid <= he]
        before = [(he, name) for name, (hs, he) in host if he <= mid]
        what = (min(covering)[1] if covering
                else f"host between ops, after {max(before)[1]}" if before else "host before any op")
        named.append([what, (e - s) * 1e-6])
    return dict(kernels=kernels, busy_s=sum(e - s for s, e in busy) * 1e-6, window_s=wall, calls=n,
                device_op_count=len(dev),
                device_ops=sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:10],
                idle_gaps=named)
