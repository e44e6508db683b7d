"""decode_ms.video: the span of each call of the program's VAE decoder, read
on the device's clock: milliseconds between the CUDA events the probe
records at the call's start and end, summed per request completed in the
window. It holds whatever the device does between them, idle gaps inside
the decoder's calls included; it is not read from the trace."""

from . import delta, window


def read(run, suffix):
    w = window(run, suffix)
    if w is None or not run.decode_events:
        return None
    first = w["counts"]["frames"] - delta(run, w, "frames")
    events = run.decode_events[first:w["counts"]["frames"]]
    n = sum(u.ok for u in w["units"])
    if not events or not n:
        return None
    return sum(s.elapsed_time(e) for s, e in events) / n
