"""The program's own spans: named stages of a request or a training step,
recorded only while a ``torch.profiler`` session runs.

    with span("local_stage"):
        ...

With no profiler running, ``span`` returns one shared no-op context after
a single flag check: it allocates nothing, makes no CUDA call and records
nothing. Under a profiler a span

- opens a plain CPU range of its name on the profiler's timeline (not a
  user annotation, which the profiler would mirror onto the device
  timeline as a device event), so each stage sits on the profiler's clock
  beside the operations and kernels it launched, and an idle gap of the
  device inside it is named by the stage;
- takes the host clock at entry and exit and, once CUDA is in use, records
  a timing CUDA event on the current stream at each end;
- appends a record: its name, its parent (the innermost span open when it
  opened) and its root (the outermost: one request or one step).

Open spans form one stack for the whole process, not one per thread: while
``loss.backward()`` blocks the calling thread, autograd's device thread
reruns checkpointed forwards, and the spans opened there nest under the
``backward`` span. A span closes on an exception too (a checkpoint's
recompute may stop early by raising).

``summary()`` gives each span name's calls, host and device time and their
self times (the part of a span's interval that none of its child spans
covers), and the summed ``pairs``. An operator profiling ``run_eval`` sees
the spans in the exported trace and reads ``summary()`` after it; the
records stay until ``reset()``.
"""

from __future__ import annotations

import itertools
import time
from collections import defaultdict
from typing import List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


class _Off:
    """The span returned when no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()

_STACK: list = []        # the open spans, innermost last
_RECORDS: list = []      # closed spans, in the order they closed
_IDS = itertools.count(1)


def profiling() -> bool:
    """True while a profiler session runs."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str, pairs: Optional[int] = None):
    """A context that records the stage ``name`` while a profiler runs.
    ``pairs``: the image pairs the stage serves (given on a request's root)."""
    if not _autograd_profiler._is_profiler_enabled:
        return OFF
    return _Span(name, pairs)


def _cuda_event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    """An open span, and once closed its record."""

    __slots__ = ("name", "pairs", "id", "parent", "root", "range", "t0", "t1", "ev0", "ev1")

    def __init__(self, name: str, pairs: Optional[int]):
        self.name, self.pairs = name, pairs

    def __enter__(self):
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        outer = _STACK[-1] if _STACK else None
        self.id = next(_IDS)
        self.parent = outer.id if outer else None
        self.root = outer.root if outer else self.id
        self.ev0 = _cuda_event() if torch.cuda.is_initialized() else None
        self.t0 = time.perf_counter_ns()
        _STACK.append(self)
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        self.ev1 = _cuda_event() if self.ev0 is not None else None
        _STACK.remove(self)
        self.range.__exit__(*exc)
        self.range = None
        _RECORDS.append(self)
        return False


def records() -> List[_Span]:
    """The closed spans, in the order they closed."""
    return list(_RECORDS)


def reset() -> None:
    """Drop the records."""
    _RECORDS.clear()


def _covered(lo: float, hi: float, intervals) -> float:
    """The length of [lo, hi] that the union of ``intervals`` covers."""
    total, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def summary() -> dict:
    """{name: {calls, host_ms, host_self_ms, device_ms, device_self_ms,
    pairs}} over the records. Device times are the stream's interval
    between a span's two CUDA events (None where no event was recorded);
    self times leave out what the span's children cover. Synchronizes once
    when there are events; repeated calls return the same values."""
    recs = list(_RECORDS)
    if any(r.ev0 is not None for r in recs):
        torch.cuda.synchronize()
    origin = {}                    # a CUDA event of each root, its device clock's zero
    for r in recs:
        if r.ev0 is not None and (r.root not in origin or r.id == r.root):
            origin[r.root] = r.ev0
    host, device, kids = {}, {}, defaultdict(list)
    for r in recs:
        host[r.id] = (r.t0 * 1e-6, r.t1 * 1e-6)
        if r.ev0 is not None:
            o = origin[r.root]
            device[r.id] = (o.elapsed_time(r.ev0), o.elapsed_time(r.ev1))
        kids[r.parent].append(r.id)
    out = {}
    for r in recs:
        s = out.setdefault(r.name, dict(calls=0, host_ms=0.0, host_self_ms=0.0, device_ms=None,
                                         device_self_ms=None, pairs=None))
        s["calls"] += 1
        lo, hi = host[r.id]
        s["host_ms"] += hi - lo
        s["host_self_ms"] += hi - lo - _covered(lo, hi, [host[k] for k in kids[r.id]])
        if r.id in device:
            lo, hi = device[r.id]
            inner = [device[k] for k in kids[r.id] if k in device]
            s["device_ms"] = (s["device_ms"] or 0.0) + hi - lo
            s["device_self_ms"] = (s["device_self_ms"] or 0.0) + hi - lo - _covered(lo, hi, inner)
        if r.pairs is not None:
            s["pairs"] = (s["pairs"] or 0) + r.pairs
    return out
