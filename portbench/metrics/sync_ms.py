"""sync_ms.<window>: milliseconds the host waited on the card, from the
program's own spans: every ``wait.*`` span (a synchronise, a copy to or
from the card) inside the window, over the units completed in it."""

from ..spans import WAIT, window_spans
from . import window


def read(run, suffix):
    w = window(run, suffix)
    spans = window_spans(w)
    n = sum(u.ok for u in w["units"]) if w else 0
    if spans is None or not n:
        return None
    return 1e3 * sum(s.end - s.start for s in spans if s.name.startswith(WAIT)) / n
