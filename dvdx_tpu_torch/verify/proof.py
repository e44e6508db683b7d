"""Proof-of-Inference sampling primitives: the port's copy of the part of
``dvdx_tpu/verify/proof.py`` that re-execution needs."""

from __future__ import annotations

import hashlib
from typing import List


def sample_distinct_indices(domain: bytes, material: bytes, population: int,
                            k: int) -> List[int]:
    """k distinct indices in [0, population) from sha256(material || domain
    || counter), sorted: the rejection-sampling loop of the spot-check and
    video-binding samplers."""
    k = min(k, population)
    picked: List[int] = []
    counter = 0
    while len(picked) < k:
        digest = hashlib.sha256(material + domain + counter.to_bytes(4, "big")).digest()
        idx = int.from_bytes(digest[:8], "big") % population
        if idx not in picked:
            picked.append(idx)
        counter += 1
    return sorted(picked)
