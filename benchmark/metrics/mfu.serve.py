"""The networks' FLOPs a pair (``counts.models``) times the traced run's
window's pairs a second, over the configuration's peak, in %."""

from benchmark.counts.peaks import ops_per_s


def read(rec):
    if "flops_per_pair" not in rec or not rec["pairs"]:
        return None
    return 100.0 * rec["flops_per_pair"] * rec["pairs"] / rec["window_s"] / ops_per_s(rec["dtype"])
