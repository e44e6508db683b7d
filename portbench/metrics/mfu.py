"""mfu.<window>: model FLOPs of the window's completed work (each unit the
probe counted, such as UNet rows, text encode rows and decoded frames, at
the FLOPs that the family's ``model_flops`` counted on the plain reference)
over the window's wall seconds and the H100's dense bf16 peak, in percent."""

from ..costs import PEAK_BF16_FLOPS
from . import delta, window


def read(run, suffix):
    w = window(run, suffix)
    if w is None or run.flops is None:
        return None
    flops = sum(delta(run, w, counter) * f for counter, f in run.flops.items())
    return 100.0 * flops / (w["t1"] - w["t0"]) / PEAK_BF16_FLOPS
