"""Readings of the program's own spans (``blurry_edges_tpu_torch/utils/
trace.py``). The spans record only while a profiler runs, so in a run they
cover the traced sub-window's requests or steps alone. A reading is None
where the program has no spans, or none of those it needs were recorded:
untraced runs, runs on the CPU, and a program older than its spans."""


def summary() -> dict:
    try:
        from blurry_edges_tpu_torch.utils import trace
    except ImportError:
        return {}
    return trace.summary()


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


def per_step(name: str) -> float:
    """The span's host self milliseconds over the ``train_step`` spans."""
    s = summary()
    steps = s.get("train_step", {}).get("calls")
    total = _total(s, (name,), "host_self_ms")
    return total / steps if steps and total is not None else None
