"""Device operations (kernels, copies, sets) launched a step, from the
profiled steps' trace: the host's work in this launch-bound step, which
the host clock's swings from run to run do not move."""


def read(rec):
    t = rec.get("trace")
    return t["device_op_count"] / t["calls"] if t else None
