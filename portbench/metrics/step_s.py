"""step_s: the window's wall seconds over the denoise steps completed in it
(the decode, fetch, commit, spool and mp4 of a request that ends inside the
window included)."""

from . import delta, window


def read(run, suffix):
    w = window(run, "step")
    steps = delta(run, w, "steps") if w else 0
    return (w["t1"] - w["t0"]) / steps if steps else None
