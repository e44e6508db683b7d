"""The device trace of a ``--trace 1`` window: ``torch.profiler`` with CUDA
activity alone (no host operators are recorded, so the host pays for little
beyond CUPTI), read into device intervals on the host's clock.

``group_of`` and ``busy_us`` are copied from the program's
``utils/profile_step.py`` (``group_of``, ``_busy_us``), which this benchmark
does not import: kernel names are grouped into the port's kernels, matrix
products, convolutions and everything else, and busy time is the length of
the union of device intervals.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import torch

# kernel-name fragments -> group (first match wins); see the program's
# utils/profile_step.py for why each fragment is there
GROUPS = (
    ("fused_spatial_tail", ("spatial_tail_",)),
    ("fused_temporal_block", ("temporal_block_",)),
    ("flash_attention", ("flash_fwd",)),
    ("temporal_attention", ("temporal_attn",)),
    ("attention_f32", ("attention_f32",)),
    ("geglu_ff", ("geglu_ff_", "geglu_stage")),
    ("group_norm_act", ("gn_fused", "gn_moments", "gn_apply")),
    ("convolution", ("conv", "fprop", "dgrad", "implicit", "winograd", "nchw", "nhwc")),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
)


def group_of(kernel_name: str) -> str:
    low = kernel_name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """Device events of the traced span as (name, start, end) in seconds on
    the host's ``perf_counter`` clock."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.events: List[Tuple[str, float, float]] = []
        self.read_s: Optional[float] = None
        self._prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        torch.cuda.synchronize()
        t = time.perf_counter()
        self._prof.__exit__(None, None, None)
        # the raw events carry wall-clock nanoseconds: read them without
        # building the profiler's Python event tree, which takes minutes for
        # a window's million kernels
        wall0, perf0 = time.time_ns(), time.perf_counter()
        cuda = torch.autograd.DeviceType.CUDA
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() == cuda:
                self.events.append((ev.name(), perf0 + (ev.start_ns() - wall0) / 1e9,
                                    perf0 + (ev.end_ns() - wall0) / 1e9))
        self.read_s = time.perf_counter() - t
        self._prof = None
        return False

    def within(self, t0: float, t1: float) -> List[Tuple[str, float, float]]:
        """Events clipped to [t0, t1]."""
        return [(n, max(s, t0), min(e, t1)) for n, s, e in self.events if e > t0 and s < t1]
