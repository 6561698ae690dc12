"""Host self milliseconds a step of the program's `loss` spans
(global_loss_terms: each chunk's forward, and its recompute under the
backward), in the profiled steps. The profiler slows this host-bound step
(its steps take ~1.5-2x the unprofiled ones), so read it as a share of the
step."""

from benchmark.spans import per_step


def read(rec):
    return per_step("loss")
