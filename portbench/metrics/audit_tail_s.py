"""audit_tail_s: the PERCENTILE-th percentile (nearest rank) of the latencies
of every audit completed by the deadline. The percentile is the highest
that leaves at least ten audits above it in the cell's window, fixed once
from the first chip runs."""

import math

from . import window

PERCENTILE = 85


def read(run, suffix):
    w = window(run, "audit")
    lat = sorted(u.end - u.start for u in w["units"]) if w else []
    if not lat:
        return None
    return lat[max(0, math.ceil(PERCENTILE / 100 * len(lat)) - 1)]
