"""Device operations (kernels, copies, sets) a step in the profiled steps'
trace, the nodes of a replayed CUDA graph included: a count of the
device's operations, not of the host's launches."""


def read(rec):
    t = rec.get("trace")
    return t["device_op_count"] / t["calls"] if t else None
