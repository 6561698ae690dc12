"""Device milliseconds a step of the three flash-attention kernels
(forward, dK/dV, dQ; ``families.py``), in the profiled steps' trace: the
attention of the GlobalStage's forward, its recompute and its backward."""

from benchmark.families import ms_per_call


def read(rec):
    return ms_per_call(rec, "flash")
