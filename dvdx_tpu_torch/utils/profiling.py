"""Phase timing, device memory and traces, in PyTorch.

The port's copy of ``dvdx_tpu/utils/profiling.py``: the same names and
report shapes.

* PhaseTimer — named wall-clock phases with a JSON dump;
* device_memory() — the caching allocator's peak and in-use bytes and the
  card's size, in MB;
* trace() — ``torch.profiler`` over the host and the card, written as a
  Chrome trace JSON;
* annotate() — a labelled range on that trace (``record_function``).

Like the port's other entry points they act on the card unless the caller
names the CPU.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict

import torch


class PhaseTimer:
    """Accumulating named phase timer.

    with timer.phase("denoise"): ...
    timer.report() -> {"denoise": {"total_s":..., "count":..., "max_s":...}, ...}

    ``phase(name, block=True)`` waits for the work queued on ``device``
    (``torch.cuda.synchronize``) before it stops the clock; a CPU device has
    nothing queued.
    """

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.phases: Dict[str, Dict[str, float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block: bool = False):
        t0 = time.perf_counter()
        try:
            yield
            if block and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            dt = time.perf_counter() - t0
            entry = self.phases.setdefault(name, {"total_s": 0.0, "count": 0,
                                                  "max_s": 0.0})
            entry["total_s"] += dt
            entry["count"] += 1
            entry["max_s"] = max(entry["max_s"], dt)

    def report(self) -> Dict[str, Dict[str, float]]:
        return {k: dict(v) for k, v in self.phases.items()}

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)


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


def annotate(name: str):
    """Label a region on the trace."""
    return torch.profiler.record_function(name)
