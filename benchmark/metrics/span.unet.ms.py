"""Device self milliseconds a pair of the program's `unet` span
(UNet.forward, the pp densify), in the profiled requests."""

from benchmark.spans import per_pair


def read(rec):
    return per_pair(("unet",))
