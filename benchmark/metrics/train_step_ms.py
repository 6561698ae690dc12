"""The window's milliseconds over the optimizer steps it completed."""


def read(rec):
    return rec["window_s"] / rec["steps"] * 1e3 if rec.get("steps") else None
