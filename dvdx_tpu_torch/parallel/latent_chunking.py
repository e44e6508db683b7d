"""Latent chunk / stitch API in numpy, for tools that ship chunks between
processes (the chunk coordinator and its workers). Counterpart of
``dvdx_tpu/parallel/latent_chunking.py``, over ``parallel.chunking``."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .chunking import ChunkPlan, blend_chunks, plan_chunks


def split_latent(latent: np.ndarray, num_chunks: int, overlap: int = 2
                 ) -> Tuple[List[np.ndarray], ChunkPlan]:
    """(F, ...) -> list of (L, ...) overlapping chunks and their plan."""
    latent = np.asarray(latent)
    plan = plan_chunks(latent.shape[0], num_chunks, overlap)
    return [latent[plan.frame_index[i]] for i in range(plan.num_chunks)], plan


def stitch_chunks(chunks: List[np.ndarray], plan: ChunkPlan) -> np.ndarray:
    """Inverse of split_latent with the linear-ramp overlap blend (float32,
    on the CPU)."""
    arr = torch.from_numpy(np.stack([np.asarray(c, np.float32) for c in chunks]))[None]
    return blend_chunks(arr, plan)[0].numpy()


def chunk_bounds(plan: ChunkPlan) -> List[Tuple[int, int]]:
    """[(start, end), ...] global frame ranges per chunk."""
    return [(int(r[0]), int(r[-1]) + 1) for r in plan.frame_index]
