"""One reader per metric family, found by the part of the metric's name
before its first dot: ``metrics/<family>.py`` defines ``read(run, suffix)``,
which returns the metric's value, or None where the run has nothing for it
to read (the harness then leaves the metric out of the result line).

``suffix`` names the window a metric is taken over, one of those the
cell's traffic driver names in its ``WINDOWS`` (``traffic/common.py`` has
the window functions: ``completed_by_deadline``, ``through_close``); an
end-to-end metric's reader names its window itself.
"""

from __future__ import annotations

import importlib
from typing import Optional


def reader(name: str):
    family, _, _ = name.partition(".")
    return importlib.import_module(f"{__name__}.{family}").read


def window(run, name: str) -> Optional[dict]:
    """The window ``name`` of a run's record, as its driver cuts it."""
    return run.record.window(name)


def delta(run, w: dict, key: str) -> int:
    return w["counts"][key] - run.record.counts0[key]


def mean_timing(w: Optional[dict], *keys: str) -> Optional[float]:
    """Mean over the window's successful units of the sum of the program's
    own phase seconds ``keys``, in milliseconds."""
    if w is None:
        return None
    vals = [sum(u.timings[k] for k in keys) for u in w["units"]
            if u.ok and all(k in u.timings for k in keys)]
    return 1e3 * sum(vals) / len(vals) if vals else None
