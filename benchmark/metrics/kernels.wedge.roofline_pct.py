"""wedge_colors and wedge_render together: their launches' least time over
their device time, in %."""

from benchmark.roofline import share


def read(rec):
    return share(rec, ("wedge_colors", "wedge_render"))
