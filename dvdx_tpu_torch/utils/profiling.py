"""Spans, device memory and traces, in PyTorch.

* span() — a named region of the program: recorded, with the span open
  around it, while recording is on, and filling a phase-timings dict
  (``timings=``) whether it is on or not;
* spans() / recording() — the recorded spans, and a block that records
  without a profiler;
* device_memory() — the caching allocator's peak and in-use bytes and the
  card's size, in MB;
* trace() — ``torch.profiler`` over the host and the card, written as a
  Chrome trace JSON, on which each recorded span is a labelled range.

Recording is on while a ``torch.profiler`` session is active, or inside
``recording()``. Off, ``span`` is one flag check and returns a shared object
that does nothing (a span that fills a timings dict reads the clock twice);
on or off, a span never synchronises the card, records a CUDA event or
touches a tensor. Spans are kept in memory, in a bounded deque of the last
``MAX_SPANS``, and never written out by this module. Their clock is
``time.perf_counter_ns``, the monotonic clock ``time.perf_counter`` reads,
so a span lies beside any interval taken on that clock with no conversion.

Like the port's other entry points, ``device_memory`` and ``trace`` act on
the card unless the caller names the CPU.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

MAX_SPANS = 1 << 16


class Span(NamedTuple):
    """One recorded span. ``parent`` is the id of the span open around it in
    the same thread or task, 0 at a root."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int


_records: "collections.deque[Span]" = collections.deque(maxlen=MAX_SPANS)
# the id of the span open in this thread or task
_open: contextvars.ContextVar = contextvars.ContextVar("dvdx_open_span", default=0)
_ids = itertools.count(1)
_forced = 0  # depth of open recording() blocks
_forced_lock = threading.Lock()


class _Off:
    """The one span handed out while recording is off and no timings dict
    is filled: it does nothing. Its ``__enter__`` and ``__exit__`` are C
    functions, so that entering and leaving it runs no Python frame:
    ``__enter__`` returns None, and ``__exit__`` takes the three exception
    arguments and returns "", which lets an exception through."""

    __slots__ = ()
    __enter__ = itertools.repeat(None).__next__
    __exit__ = "".format

    async def __aenter__(self):
        return None

    async def __aexit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "timings", "key", "accumulate", "seconds", "_record", "_t0",
                 "_id", "_prev", "_rf")

    def __init__(self, name, timings, key, accumulate, record):
        self.name, self.timings, self.key, self.accumulate = name, timings, key, accumulate
        self._record = record
        self._rf = None
        self.seconds = 0.0

    def _enter(self, ranged: bool):
        if self._record:
            self._id = next(_ids)
            self._prev = _open.get()
            _open.set(self._id)
            if ranged and _autograd_profiler._is_profiler_enabled:
                self._rf = torch.profiler.record_function(self.name)
                self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def _exit(self, failed: bool):
        t1 = time.perf_counter_ns()
        self.seconds = (t1 - self._t0) / 1e9
        if self._record:
            if self._rf is not None:
                self._rf.__exit__(None, None, None)
            _open.set(self._prev)
            _records.append(Span(self.name, self._t0, t1, self._id, self._prev))
        if self.timings is not None and not failed:
            key = self.key or self.name
            before = self.timings.get(key, 0.0) if self.accumulate else 0.0
            self.timings[key] = round(before + self.seconds, 4)
        return False

    def __enter__(self):
        return self._enter(True)

    def __exit__(self, exc_type, exc, tb):
        return self._exit(exc_type is not None)

    async def __aenter__(self):
        return self._enter(False)

    async def __aexit__(self, exc_type, exc, tb):
        return self._exit(exc_type is not None)


def span(name: str, timings: Optional[dict] = None, key: Optional[str] = None,
         accumulate: bool = False):
    """A context manager over one region of the program, named ``name``.

    With ``timings`` the span writes its seconds, rounded to 0.1 ms, into
    ``timings[key or name]`` when its block ends without an exception,
    whether recording is on or not, and keeps them in ``.seconds``;
    ``accumulate=True`` adds them to what the entry holds.

    While recording is on under a profiler, ``with span(...)`` also enters a
    ``record_function`` range. A span that stays open across an ``await`` is
    entered with ``async with span(...)``: it is recorded, but is no range,
    since tasks that share a thread would open and close their ranges out
    of order."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        if timings is None:
            return _OFF
        return _Span(name, timings, key, accumulate, False)
    return _Span(name, timings, key, accumulate, True)


def spans() -> List[Span]:
    """A snapshot of the recorded spans, oldest first (the last
    ``MAX_SPANS``)."""
    return list(_records)


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without a profiler."""
    global _forced
    with _forced_lock:
        _forced += 1
    try:
        yield
    finally:
        with _forced_lock:
            _forced -= 1


def device_memory(device="cuda") -> Dict[str, float]:
    """Memory of ``device`` in MB: the caching allocator's peak and current
    allocated bytes (``torch.cuda.memory_stats``; the peak is
    ``torch.cuda.max_memory_allocated``) and the card's total
    (``torch.cuda.mem_get_info``). A CPU device has no such stats: zeros, as
    the JAX function gives for a device without them."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"peak_mb": 0.0, "in_use_mb": 0.0, "limit_mb": 0.0}
    stats = torch.cuda.memory_stats(dev)
    _, total = torch.cuda.mem_get_info(dev)
    return {
        "peak_mb": stats.get("allocated_bytes.all.peak", 0) / 2**20,
        "in_use_mb": stats.get("allocated_bytes.all.current", 0) / 2**20,
        "limit_mb": total / 2**20,
    }


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Profile the block with ``torch.profiler`` (host activity, and the
    card's kernels where ``device`` is a CUDA device) and write a Chrome
    trace JSON into ``log_dir`` (chrome://tracing, Perfetto, TensorBoard's
    profile plugin). Yields the file's path; the file is written when the
    block ends, after the card's queued work."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof = profile(activities=activities)
    prof.start()
    try:
        yield path
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        prof.stop()
        prof.export_chrome_trace(path)

