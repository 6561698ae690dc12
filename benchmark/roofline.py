"""The share of a group of kernels' roofline in a traced sub-window: the
sum of each launch's least time (``counts.kernels``) over the sum of the
kernels' device times, by kernel name in the profiler's trace. None where
the trace holds no launch of them."""

from benchmark.counts.kernels import least_seconds


def share(rec, kernels) -> float:
    trace = rec.get("trace")
    if not trace:
        return None
    least = spent = 0.0
    for k in kernels:
        runs = [d for name, ds in trace["kernels"].items() if f"{k}_kernel" in name for d in ds]
        least += len(runs) * least_seconds(k, rec["launch_shapes"][k], rec["dtype"])
        spent += sum(runs)
    return 100.0 * least / spent if spent > 0 else None
