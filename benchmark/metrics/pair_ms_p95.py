"""The 95th percentile of the requests' latency in the window, numpy
pair in to maps in host memory, over all requests (linear interpolation
between order statistics)."""

import numpy as np


def read(rec):
    lat = rec.get("latencies_s")
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
