"""Milliseconds a step in which some device activity ran, from the
profiled steps' trace: the device's own work a step, which a fused loss
or a faster kernel moves and the host clock's swings do not."""


def read(rec):
    t = rec.get("trace")
    return 1e3 * t["busy_s"] / t["calls"] if t else None
