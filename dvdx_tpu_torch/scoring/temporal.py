"""Chunk-boundary temporal metrics for the distribution benchmarks.

This package's own copy of ``dvdx_tpu/scoring/temporal.py`` (framework-free
numpy): at each chunk boundary, the mean L1 between the last frame of chunk
i and the first frame of chunk i+1 ("temp_instab") and the optical-flow warp
error across it ("flow_err", OpenCV Farneback; 0 where cv2 is absent).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


def boundary_pairs(chunk_bounds: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Chunk ranges [(s, e), ...] -> (last frame of chunk i, first frame of
    chunk i+1) index pairs."""
    pairs = []
    for (_s0, e0), (s1, e1) in zip(chunk_bounds[:-1], chunk_bounds[1:]):
        if e0 - 1 >= 0 and s1 < e1:
            pairs.append((e0 - 1, s1))
    return pairs


def temporal_instability(frames_uint8: np.ndarray,
                         pairs: Sequence[Tuple[int, int]]) -> float:
    """Mean absolute pixel difference ([0, 1] scale) over the pairs."""
    if not pairs:
        return 0.0
    x = frames_uint8.astype(np.float32) / 255.0
    return float(np.mean([float(np.abs(x[b] - x[a]).mean()) for a, b in pairs]))


def flow_warp_error(frames_uint8: np.ndarray,
                    pairs: Sequence[Tuple[int, int]]) -> float:
    """Warp frame a by the Farneback flow a -> b and take the mean L1
    residual against frame b ([0, 1] scale), averaged over the pairs."""
    if not pairs or not _HAS_CV2:
        return 0.0
    errs = []
    for a, b in pairs:
        ga = frames_uint8[a].mean(axis=-1).astype(np.uint8)
        gb = frames_uint8[b].mean(axis=-1).astype(np.uint8)
        flow = cv2.calcOpticalFlowFarneback(ga, gb, None, 0.5, 3, 15, 3, 5, 1.2, 0)
        h, w = ga.shape
        gx, gy = np.meshgrid(np.arange(w), np.arange(h))
        mx = (gx + flow[..., 0]).astype(np.float32)
        my = (gy + flow[..., 1]).astype(np.float32)
        warped = cv2.remap(ga, mx, my, cv2.INTER_LINEAR)
        errs.append(float(np.abs(warped.astype(np.float32) - gb).mean() / 255.0))
    return float(np.mean(errs))


def global_temporal_instability(frames_uint8: np.ndarray) -> float:
    """Mean consecutive-frame L1 over the whole video."""
    if frames_uint8.shape[0] < 2:
        return 0.0
    x = frames_uint8.astype(np.float32) / 255.0
    return float(np.abs(np.diff(x, axis=0)).mean())
