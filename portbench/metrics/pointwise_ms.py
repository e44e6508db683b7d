"""pointwise_ms.<window>: device milliseconds a denoiser call of every
kernel outside the matrix products, the convolutions and the port's own
kernels (the trace's group "other", less the port's bias epilogues,
QK-norm and DiT epilogue kernels, which that grouping does not name, and
less memory copies and memsets): the LayerNorms, modulations, gates, GELU and the rotary tables'
traffic of a DiT step, and the little of the window's text encode, base
noise and DDIM updates beside them. Over the program's ``dit`` spans that
the window holds whole; where that count is not the probe's count of
denoiser calls in the window, nothing is read."""

from ..spans import window_spans
from ..trace import group_of
from . import delta, window

PORT_KERNELS = ("bias_epilogue", "qk_norm_rope", "bias_gelu_rows", "gated_residual_rows")
NOT_KERNELS = ("memcpy", "memset")


def dit_calls(run, w):
    """The ``dit`` spans whole inside the window, where there are some and
    they number the probe's denoiser calls in it; else None."""
    if w is None or run.trace is None:
        return None
    spans = window_spans(w)
    if spans is None:
        return None
    n = sum(1 for s in spans if s.name == "dit" and s.start > w["t0"] and s.end < w["t1"])
    return n if n and n == delta(run, w, "unet") else None


def read(run, suffix):
    w = window(run, suffix)
    calls = dit_calls(run, w)
    if not calls:
        return None
    ms = 0.0
    for n, s, e in run.trace.within(w["t0"], w["t1"]):
        low = n.lower()
        if group_of(n) == "other" and not any(k in low for k in PORT_KERNELS + NOT_KERNELS):
            ms += e - s
    return 1e3 * ms / calls
