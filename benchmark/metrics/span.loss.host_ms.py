"""Host self milliseconds of the program's `loss` spans (global_loss_terms:
each chunk's forward, and its recompute under the backward) in one eager
step (``TrainStep.eager``: the data-parallel trainer's step and the first of
each batch signature) that the traced run profiles on its own after its
replayed steps, which hold no stage spans. The profiler slows this host-
bound step (~1.5-2x), so read it as a share of the eager step. None without
that step's spans."""

from benchmark.spans import per_step


def read(rec):
    return per_step("loss", rec.get("eager_spans"))
