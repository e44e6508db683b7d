"""step_host_ms.<window>: the host's milliseconds a denoise step, from the
program's own spans: the mean over the window's whole ``denoise_step``
spans of each one's length less the ``wait.*`` spans under it (the host's
enqueue of the step's UNet calls, guidance and DDIM update)."""

from ..spans import waits_by_ancestor, window_spans
from . import window


def read(run, suffix):
    w = window(run, suffix)
    spans = window_spans(w)
    if spans is None:
        return None
    steps = [s for s in spans if s.name == "denoise_step"
             and s.start > w["t0"] and s.end < w["t1"]]
    if not steps:
        return None
    waits = waits_by_ancestor(spans, "denoise_step")
    return 1e3 * sum(s.end - s.start - waits[s.id] for s in steps) / len(steps)
