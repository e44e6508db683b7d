"""audit_s: seconds from the window's start to the end of its last audit
completed by the deadline, over the audits completed."""

from . import window


def read(run, suffix):
    w = window(run, "audit")
    n = sum(u.ok for u in w["units"]) if w else 0
    return (w["t1"] - w["t0"]) / n if n else None
