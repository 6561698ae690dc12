"""Seconds from the process's start to the first timed request or step:
weights, inputs, the program's build or load and the warm-up."""


def read(rec):
    return rec["setup_s"]
