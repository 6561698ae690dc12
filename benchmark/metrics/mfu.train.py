"""3 x the global stage's forward FLOPs x the samples of a step, over the
window's time a step and the configuration's peak, in %."""

from benchmark.counts.peaks import ops_per_s


def read(rec):
    if "flops_per_step" not in rec or not rec["steps"]:
        return None
    return 100.0 * rec["flops_per_step"] * rec["steps"] / rec["window_s"] / ops_per_s(rec["dtype"])
