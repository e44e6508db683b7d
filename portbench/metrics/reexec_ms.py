"""reexec_ms.audit: the validator's own ``timings_s["reexecution"]`` (one text
encode and the k re-executed steps), per audit."""

from . import mean_timing, window


def read(run, suffix):
    return mean_timing(window(run, suffix), "reexecution")
