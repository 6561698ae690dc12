"""Device self milliseconds a pair of the program's `softmax_bf16` span
(GlobalStage's bfloat16 softmax, each operation a pass over the scores),
in the profiled requests."""

from benchmark.spans import per_pair


def read(rec):
    return per_pair(("softmax_bf16",))
