"""Host self milliseconds of the program's `backward` span (loss.backward():
autograd's launches, without the chunks' recomputed forwards and losses,
which are spans of their own) in one eager step (``TrainStep.eager``: the
data-parallel trainer's step and the first of each batch signature) that the
traced run profiles on its own after its replayed steps, which hold no stage
spans. The profiler slows this host-bound step (~1.5-2x), so read it as a
share of the eager step. None without that step's spans."""

from benchmark.spans import per_step


def read(rec):
    return per_step("backward", rec.get("eager_spans"))
