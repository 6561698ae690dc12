"""Launches of the LocalStage's tail kernel (every kernel whose name holds
``local_epilogue``) in the profiled requests over the calls of the
program's ``local_stage`` span: 10 where each of a forward's ten junctions
runs in the kernel. None without a trace, without the span, or where no
such kernel ran."""

from benchmark import spans


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    launches = sum(len(spans) for name, spans in t["kernels"].items() if "local_epilogue" in name)
    calls = spans.summary().get("local_stage", {}).get("calls")
    return launches / calls if launches and calls else None
