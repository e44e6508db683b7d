"""Temporal latent chunking: plan, gather, ramp-blend.

Counterpart of ``dvdx_tpu/parallel/chunking.py``. The frame axis is split
into overlapping chunks of one length L, denoised independently (the chunk
axis folds into the batch), and stitched with linear-ramp overlap weights.
Planning is host numpy and a function of (frames, chunks, overlap) alone, so
a validator holding a miner's committed chunk count rebuilds the same plan.
Gathering is an ``index_select`` on the frame axis; blending is an
``index_add_`` of the weighted chunk slots divided by the summed weights, in
float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """Static chunking layout.

    frame_index: (n_chunks, L) int32 -- global frame id per chunk slot.
    weights:     (n_chunks, L) f32   -- ramp blend weight per chunk slot.
    num_frames:  original frame count F.
    """

    frame_index: np.ndarray
    weights: np.ndarray
    num_frames: int

    @property
    def num_chunks(self) -> int:
        return int(self.frame_index.shape[0])

    @property
    def chunk_len(self) -> int:
        return int(self.frame_index.shape[1])


def auto_chunk_count(num_frames: int, num_shards: int, target_len: int = 8) -> int:
    """At least one chunk per shard, chunks near ``target_len`` frames, the
    count rounded up to a multiple of ``num_shards`` (and at most F)."""
    by_len = max(1, round(num_frames / target_len))
    n = max(num_shards, by_len)
    if n % num_shards:
        n += num_shards - n % num_shards
    return min(n, num_frames)


def plan_chunks(num_frames: int, num_chunks: int, overlap: int = 2) -> ChunkPlan:
    """Evenly spaced overlapping chunks covering [0, F), all of one length
    L (L = F for one chunk). Consecutive chunks share at least ``overlap``
    frames; each chunk's weights ramp linearly across the frames it shares
    with each neighbour and are 1 elsewhere, the video's ends included."""
    if num_chunks <= 1:
        idx = np.arange(num_frames, dtype=np.int32)[None]
        w = np.ones((1, num_frames), np.float32)
        return ChunkPlan(idx, w, num_frames)

    stride = (num_frames - overlap) / num_chunks
    length = int(np.ceil(stride)) + overlap
    length = min(max(length, overlap + 1), num_frames)
    starts = np.round(np.linspace(0, num_frames - length, num_chunks)).astype(np.int64)
    idx = (starts[:, None] + np.arange(length)[None, :]).astype(np.int32)

    w = np.ones((num_chunks, length), np.float32)
    for i in range(num_chunks):
        s, e = starts[i], starts[i] + length
        if i > 0:
            ov = max(0, min(starts[i - 1] + length, e) - s)
            if ov > 0:
                w[i, :ov] *= (np.arange(ov) + 1) / (ov + 1)
        if i < num_chunks - 1:
            ov = max(0, e - max(starts[i + 1], s))
            if ov > 0:
                w[i, length - ov:] *= (np.arange(ov)[::-1] + 1) / (ov + 1)
    return ChunkPlan(idx, w, num_frames)


def gather_chunks(latent: torch.Tensor, plan: ChunkPlan) -> torch.Tensor:
    """(B, F, h, w, C) -> (B, n_chunks, L, h, w, C)."""
    idx = torch.from_numpy(plan.frame_index.reshape(-1)).long().to(latent.device)
    out = latent.index_select(1, idx)
    return out.reshape((latent.shape[0], plan.num_chunks, plan.chunk_len) + latent.shape[2:])


def blend_chunks(chunks: torch.Tensor, plan: ChunkPlan) -> torch.Tensor:
    """(B, n_chunks, L, h, w, C) -> (B, F, h, w, C) float32:
    out[f] = sum_i w[i, j] * chunks[i, j] / sum_i w[i, j] over the slots with
    frame_index[i, j] == f."""
    b, n, l = chunks.shape[:3]
    rest = chunks.shape[3:]
    dev = chunks.device
    w = torch.from_numpy(plan.weights).to(dev).reshape(n * l)
    seg = torch.from_numpy(plan.frame_index.reshape(-1)).long().to(dev)
    ones = (1,) * len(rest)
    weighted = chunks.float().reshape((b, n * l) + rest) * w.reshape((1, n * l) + ones)
    num = torch.zeros((b, plan.num_frames) + rest, dtype=torch.float32, device=dev)
    num.index_add_(1, seg, weighted)
    den = torch.zeros(plan.num_frames, dtype=torch.float32, device=dev).index_add_(0, seg, w)
    return num / den.reshape((1, plan.num_frames) + ones)


def chunk_frame_positions(plan: ChunkPlan, device="cuda") -> torch.Tensor:
    """Relative positions (L,): each chunk is denoised as a clip of its own."""
    return torch.arange(plan.chunk_len, device=device)
