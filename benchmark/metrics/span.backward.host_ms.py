"""Host self milliseconds a step of the program's `backward` span
(loss.backward(): autograd's launches, without the chunks' recomputed
forwards and losses, which are spans of their own), in the profiled steps.
The profiler slows this host-bound step (its steps take ~1.5-2x the
unprofiled ones), so read it as a share of the step."""

from benchmark.spans import per_step


def read(rec):
    return per_step("backward")
