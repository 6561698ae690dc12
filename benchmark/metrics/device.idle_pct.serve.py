"""The share of the profiled sub-window in which no device activity ran,
in %."""


def read(rec):
    t = rec.get("trace")
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t else None
