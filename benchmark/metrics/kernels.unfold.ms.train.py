"""Device milliseconds a step of ``im2col`` and ``col2im`` (``families.py``),
in the profiled steps' trace: the loss chain's ``F.unfold`` and ``F.fold``
(``ops/patchify.py``) and their backwards."""

from benchmark.families import ms_per_call


def read(rec):
    return ms_per_call(rec, "unfold")
