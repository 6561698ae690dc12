"""Device self milliseconds a pair of the program's `stitch` spans (the
587x587 path's copies of each chunk's kept patches into the big grid, and
the ranks' sum under data parallelism) and `fold` spans (the overlap-add
of the patch grids into maps), in the profiled requests."""

from benchmark.spans import per_pair


def read(rec):
    return per_pair(("stitch", "fold"))
