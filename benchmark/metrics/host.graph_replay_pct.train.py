"""The share of the profiled training steps that replayed a CUDA graph, in
%: the program's `graph_replay` spans over its `train_step` spans (those
the training kind keeps of the profiled steps). None where no step
replayed one: a program without the graph, or an untraced run."""

from benchmark.spans import summary


def read(rec):
    s = summary(rec.get("spans"))
    steps = s.get("train_step", {}).get("calls")
    replays = s.get("graph_replay", {}).get("calls")
    return 100.0 * replays / steps if steps and replays else None
