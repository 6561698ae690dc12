"""Host self milliseconds a step of the program's `graph_replay` spans, in
the profiled steps (the spans the training kind keeps of them): what the host still does in a step held in a CUDA
graph (the batch and the loss weights copied into the graph's buffers, the
dropout masks drawn into them, the launch). None without such spans."""

from benchmark.spans import per_step


def read(rec):
    return per_step("graph_replay", rec.get("spans"))
