"""Host self milliseconds a step of the program's `optimizer` span
(the gradients' mean over ranks, the global-norm clip and AdamW's step),
in the profiled steps. The profiler slows this host-bound step (its steps
take ~1.5-2x the unprofiled ones), so read it as a share of the step."""

from benchmark.spans import per_step


def read(rec):
    return per_step("optimizer")
