"""Device milliseconds a step of PyTorch's elementwise, reduction and
softmax kernels (``families.py``), in the profiled steps' trace: mostly
the loss chain (``train/global_.py::global_loss_terms``), forward and
recompute, and its backward; also the GlobalStage's activations, dropout
and residual sums, and the gradient clip."""

from benchmark.families import ms_per_call


def read(rec):
    return ms_per_call(rec, "elementwise")
