"""Pairs completed in the window over the window's seconds."""


def read(rec):
    if "pairs" not in rec or not rec["window_s"]:
        return None
    return rec["pairs"] / rec["window_s"]
