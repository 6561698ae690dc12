"""Device milliseconds a step of the foreach kernels
(``multi_tensor_apply``; ``families.py``), in the profiled steps' trace:
the capturable AdamW's update. The clip's norms and scaling are reductions
and elementwise kernels, counted in ``kernels.elementwise.ms.train``."""

from benchmark.families import ms_per_call


def read(rec):
    return ms_per_call(rec, "optimizer")
