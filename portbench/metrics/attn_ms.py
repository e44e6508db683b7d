"""attn_ms.<window>: device milliseconds of the flash-attention kernel a
denoiser call: the flash group's time in the trace over the window, over
the program's ``dit`` spans (one a transformer call) that the window holds
whole. Where that count is not the probe's count of denoiser calls in the
window (a program without the spans, or a denoiser that is no DiT), nothing
is read."""

from ..trace import group_of
from . import window
from .pointwise_ms import dit_calls


def read(run, suffix):
    w = window(run, suffix)
    calls = dit_calls(run, w)
    if not calls:
        return None
    ms = sum(e - s for n, s, e in run.trace.within(w["t0"], w["t1"])
             if group_of(n) == "flash_attention")
    return 1e3 * ms / calls
