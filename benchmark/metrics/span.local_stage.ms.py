"""Device self milliseconds a pair of the program's `local_stage` span
(LocalStage.forward), in the profiled requests."""

from benchmark.spans import per_pair


def read(rec):
    return per_pair(("local_stage",))
