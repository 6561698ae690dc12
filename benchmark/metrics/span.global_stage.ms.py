"""Device self milliseconds a pair of the program's `global_stage` span
(GlobalStage.forward), in the profiled requests."""

from benchmark.spans import per_pair


def read(rec):
    return per_pair(("global_stage",))
