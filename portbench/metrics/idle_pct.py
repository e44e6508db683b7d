"""idle_pct.<window>: the share of the window in which no operation ran on
the device (one minus the union of device intervals over the wall time),
in percent."""

from ..trace import busy_us
from . import window


def read(run, suffix):
    w = window(run, suffix)
    if w is None or run.trace is None:
        return None
    busy = busy_us([(s, e) for _, s, e in run.trace.within(w["t0"], w["t1"])])
    return 100.0 * (1.0 - busy / (w["t1"] - w["t0"]))
