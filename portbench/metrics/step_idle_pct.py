"""step_idle_pct.<window>: the share of the window, in percent, in which no
device interval ran while the host was inside one of the program's
``denoise_step`` spans: the part of ``idle_pct`` that falls while the host
enqueues the denoiser."""

from ..spans import overlap_s, window_spans
from ..trace import busy_us, merged
from . import window


def read(run, suffix):
    w = window(run, suffix)
    if run.trace is None:
        return None
    spans = window_spans(w)
    if spans is None:
        return None
    steps = merged([(s.start, s.end) for s in spans if s.name == "denoise_step"])
    if not steps:
        return None
    device = [(s, e) for _, s, e in run.trace.within(w["t0"], w["t1"])]
    idle = busy_us(steps) - overlap_s(steps, device)
    return 100.0 * idle / (w["t1"] - w["t0"])
