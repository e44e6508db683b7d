"""Shared scoring-path helpers."""

from __future__ import annotations

import numpy as np
import torch


def as_device_u8(frames_uint8, device) -> torch.Tensor:
    """uint8 frames (host numpy or a tensor) -> uint8 tensor on ``device``,
    one copy. A tensor already there passes through untouched, so one
    transfer of the decoded video serves every scoring program."""
    if isinstance(frames_uint8, torch.Tensor):
        return frames_uint8.to(device)
    return torch.from_numpy(np.ascontiguousarray(frames_uint8)).to(device)
