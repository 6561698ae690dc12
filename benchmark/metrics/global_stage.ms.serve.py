"""Device milliseconds a pair in the network 'global', by CUDA events on
forward hooks the benchmark registers, summed over the hooked window."""


def read(rec):
    return rec.get("layer_ms_per_pair", {}).get("global")
