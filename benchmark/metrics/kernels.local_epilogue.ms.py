"""Device milliseconds a pair of the LocalStage's tail kernel
(``csrc/local_epilogue.cu``: eval BatchNorm, the residual sum, Smish and
the max-pool after each convolution) in the profiled requests, by name:
every launch whose kernel name holds ``local_epilogue``. None without a
trace or where no such kernel ran (a program without it, the bfloat16
networks)."""


def read(rec):
    t = rec.get("trace")
    if not t or not rec.get("latencies_s"):
        return None
    times = [s for name, spans in t["kernels"].items() if "local_epilogue" in name for s in spans]
    pairs = t["calls"] * rec["pairs"] // len(rec["latencies_s"])
    return 1e3 * sum(times) / pairs if times else None
