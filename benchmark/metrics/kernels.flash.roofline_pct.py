"""The three flash-attention kernels together (forward, dK/dV, dQ): their
launches' least time over their device time, in %."""

from benchmark.roofline import share


def read(rec):
    return share(rec, ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"))
