"""The program's own spans (``dvdx_tpu_torch.utils.profiling``) over a
window, for the per-layer metrics that read them.

The program records spans while a ``torch.profiler`` session is active,
which is what a ``--trace 1`` window is, or inside its
``profiling.recording()``. A span's clock is ``time.perf_counter_ns``, the
clock of the window's edges and of the device trace's intervals, so a span
is read here in seconds with no conversion. A program without the
recorder, or a window in which it recorded nothing, reads as None.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

from .trace import merged

WAIT = "wait."


class Span(NamedTuple):
    name: str
    start: float  # seconds on perf_counter, clipped to the window
    end: float
    id: int
    parent: int


def window_spans(w: Optional[dict]) -> Optional[List[Span]]:
    """The spans that overlap the window ``w``, clipped to it, oldest
    first; None where there are none to read."""
    if w is None:
        return None
    from dvdx_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    t0, t1 = w["t0"], w["t1"]
    out = []
    for s in read():
        start, end = s.start_ns / 1e9, s.end_ns / 1e9
        if end > t0 and start < t1:
            out.append(Span(s.name, max(start, t0), min(end, t1), s.id, s.parent))
    return out or None


def waits_by_ancestor(spans: List[Span], name: str) -> dict:
    """{id of a span named ``name``: seconds of the ``wait.*`` spans under
    it}."""
    by_id = {s.id: s for s in spans}
    out = {s.id: 0.0 for s in spans if s.name == name}
    for s in spans:
        if not s.name.startswith(WAIT):
            continue
        up = by_id.get(s.parent)
        while up is not None and up.name != name:
            up = by_id.get(up.parent)
        if up is not None:
            out[up.id] += s.end - s.start
    return out


def overlap_s(a, b) -> float:
    """Length of the intersection of two sets of [start, end) intervals."""
    a, b = merged(a), merged(b)
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_by_innermost(spans: List[Span], device, t0: float, t1: float) -> dict:
    """{name of the innermost span open: seconds of [t0, t1] in which no
    device interval of ``device`` ran}, largest first; ``None`` names the
    idle time under no span. The innermost span is the one that started
    last of those open."""
    busy = merged(device)
    idle, at = [], t0
    for s, e in busy + [(t1, t1)]:
        if s > at:
            idle.append((at, min(s, t1)))
        at = max(at, e)
    edges = sorted([(s.start, 1, s) for s in spans] + [(s.end, 0, s) for s in spans],
                   key=lambda x: (x[0], x[1]))
    open_, out, prev, j = {}, {}, t0, 0
    for t, starts, s in edges + [(t1, 0, None)]:
        if t > prev:
            inner = max(open_.values(), key=lambda o: (o.start, o.id)).name if open_ else None
            while j < len(idle) and idle[j][1] <= prev:
                j += 1
            k = j
            while k < len(idle) and idle[k][0] < t:
                cut = min(t, idle[k][1]) - max(prev, idle[k][0])
                if cut > 0:
                    out[inner] = out.get(inner, 0.0) + cut
                k += 1
            prev = t
        if s is not None:
            if starts:
                open_[s.id] = s
            else:
                open_.pop(s.id, None)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
