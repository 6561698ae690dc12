"""torch.cuda.max_memory_allocated() after a reset at the window's start,
read once the window (and the traced sub-window) closed, in GiB."""


def read(rec):
    return rec["peak_window_bytes"] / 2 ** 30 if rec.get("peak_window_bytes") else None
