"""kernel_roofline.<window>: the six bf16 model-path kernels' least time over
the window (each counted unit's bound, from the shapes the set-up's hooks
saw in one unit of each kind the family names, times the units the probe
counted in the window) over their device time in the trace, in percent.
The kernels' own launch counters must agree with the counted units; where
they do not, or the window ran none of them, nothing is read."""

from ..costs import MODEL_PATH
from ..trace import group_of
from . import delta, window


def read(run, suffix):
    w = window(run, suffix)
    if w is None or run.bounds is None or run.trace is None:
        return None
    units = {counter: delta(run, w, counter) for counter in run.bounds}
    bound = 0.0
    for k in MODEL_PATH:
        launches = sum(n * run.bounds[c][k]["launches"] for c, n in units.items())
        if delta(run, w, f"launch.{k}") != launches:
            return None
        bound += sum(n * run.bounds[c][k]["bound_ms"] for c, n in units.items())
    device_s = sum(e - s for n, s, e in run.trace.within(w["t0"], w["t1"])
                   if group_of(n) in MODEL_PATH)
    return 100.0 * bound / (1e3 * device_s) if device_s > 0 else None
