"""Device milliseconds a pair of PyTorch's dtype-converting copy kernels in
the profiled requests, by name: ``bfloat16_copy_kernel_cuda`` (float32 to
bfloat16: the bfloat16 layers' casts of their inputs and float32
parameters) and the casting ``direct_copy_kernel_cuda`` (``LoadWithCast``:
bfloat16 back to float32, the networks' outputs and LayerNorm's float32
copies). None without a trace or where no such kernel ran."""


def is_cast(name: str) -> bool:
    return "bfloat16_copy_kernel_cuda" in name or (
        "direct_copy_kernel_cuda" in name and "LoadWithCast" in name)


def read(rec):
    t = rec.get("trace")
    if not t or not rec.get("latencies_s"):
        return None
    times = [s for name, spans in t["kernels"].items() if is_cast(name) for s in spans]
    pairs = t["calls"] * rec["pairs"] // len(rec["latencies_s"])
    return 1e3 * sum(times) / pairs if times else None
