"""video_s: seconds from the window's start to the end of its last request
completed by the deadline, over the requests completed (back to back, so
every second between them counts)."""

from . import window


def read(run, suffix):
    w = window(run, "video")
    n = sum(u.ok for u in w["units"]) if w else 0
    return (w["t1"] - w["t0"]) / n if n else None
