"""The keying of the global trainer's random draws (guo-research-group's
trainer draws from torch's global generator; the port keys every draw by
splitmix64 of (seed, index), as ``jax.random.fold_in`` keys JAX's). The
benchmark's frozen copy: the reference draws the same dropout masks as the
program from the same step seed, without calling the program."""

from __future__ import annotations

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A seed in [0, 2^63) derived from ``seed`` and ``data``."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1
