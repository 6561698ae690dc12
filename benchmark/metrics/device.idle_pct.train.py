"""The share of the unprofiled window's step time in which no device
activity ran, in %: one minus the device's busy time a step, from the
profiled steps' trace, over the window's own time a step. The profiler
slows this host-bound step's launches (the traced steps take longer than
the window's), so the trace's own wall would read the idle share high;
the device's busy time a step is what the profiler does not move."""


def read(rec):
    t = rec.get("trace")
    if not t or not rec["steps"]:
        return None
    return 100.0 * (1.0 - (t["busy_s"] / t["calls"]) / (rec["window_s"] / rec["steps"]))
