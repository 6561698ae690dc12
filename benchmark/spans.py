"""Readings of the program's own spans (``blurry_edges_tpu_torch/utils/
trace.py``). The spans record only while a profiler runs, so in a run they
cover the traced sub-window's requests or steps alone. A reading is None
where the program has no spans, or none of those it needs were recorded:
untraced runs, runs on the CPU, and a program older than its spans.

A kind may keep a summary in its record (the training kind keeps the
replayed steps' spans and, apart, one eager step's); a reader given one
reads it, and the program's records otherwise."""


def summary(kept: dict = None) -> dict:
    """``kept`` where given, else the summary of the program's records."""
    if kept is not None:
        return kept
    try:
        from blurry_edges_tpu_torch.utils import trace
    except ImportError:
        return {}
    return trace.summary()


def profiled(fn) -> dict:
    """The summary of the spans of ``fn()`` alone, under a profiler as the
    traced window's (CPU and, where there is one, CUDA); the program's
    records are dropped before and after."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from blurry_edges_tpu_torch.utils import trace

    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    trace.reset()
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities):
        fn()
        if cuda:
            torch.cuda.synchronize()
    s = trace.summary()
    trace.reset()
    return s


def _total(s: dict, names, key: str):
    found = [s[n][key] for n in names if n in s and s[n][key] is not None]
    return sum(found) if found else None


def per_pair(names) -> float:
    """The spans' summed device self milliseconds over the pairs the
    ``estimator`` spans served."""
    s = summary()
    pairs = s.get("estimator", {}).get("pairs")
    total = _total(s, names, "device_self_ms")
    return total / pairs if pairs and total is not None else None


def per_step(name: str, kept: dict = None) -> float:
    """The span's host self milliseconds over the ``train_step`` spans, in
    ``kept`` where given."""
    s = summary(kept)
    steps = s.get("train_step", {}).get("calls")
    total = _total(s, (name,), "host_self_ms")
    return total / steps if steps and total is not None else None
