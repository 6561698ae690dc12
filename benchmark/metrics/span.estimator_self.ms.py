"""Device self milliseconds a pair of the program's `estimator` span,
the part no stage span covers: the pair's copy in, the unfold, the
tokens, denormalize and params2etas, the block cuts, and the device's idle
time between stages, in the profiled requests."""

from benchmark.spans import per_pair


def read(rec):
    return per_pair(("estimator",))
