"""Device self milliseconds a pair of the program's `wedge_colors` and
`wedge_render` spans (the wrappers in ops/wedge_cuda.py: the launch and its
output buffers), in the profiled requests."""

from benchmark.spans import per_pair


def read(rec):
    return per_pair(("wedge_colors", "wedge_render"))
