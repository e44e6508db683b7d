"""Merkle commitments over the recorded denoising steps.

This package's own copy of ``dvdx_tpu/verify/merkle.py``, wire-compatible
with it: leaf = sha256(t as big-endian u16 || z bytes || eps bytes),
parents hash the sorted pair, odd nodes are duplicated. z and eps are
hashed as little-endian bfloat16 in channel-last (1, F, h, w, C) order, the
bytes the reference hashes, so a validator holding either implementation
recomputes the same root.

A commitment hashes its leaves with the native SHA-256
(``utils/native.py``, ``csrc/merkle.cpp``) unless ``use_native=False``
asks for the hashlib loop of ``leaf_hash``, the plain version it is held
against; the tree levels are built here, since the proofs need them.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

import numpy as np

from ..utils.native import host_array, sha256_leaves
from ..utils.profiling import span

HASH_BYTES = 32


def array_bytes(x) -> bytes:
    """Raw little-endian bytes of a torch tensor or numpy array, in its
    logical (row-major) order; bfloat16 tensors by their 16-bit patterns."""
    return host_array(x).tobytes()


def leaf_bytes(timestep: int, z, eps) -> bytes:
    return int(timestep).to_bytes(2, "big") + array_bytes(z) + array_bytes(eps)


def leaf_hash(timestep: int, z, eps) -> bytes:
    return hashlib.sha256(leaf_bytes(timestep, z, eps)).digest()


def _parent(a: bytes, b: bytes) -> bytes:
    lo, hi = (a, b) if a <= b else (b, a)
    return hashlib.sha256(lo + hi).digest()


def build_merkle_tree(leaf_hashes: Sequence[bytes]) -> List[List[bytes]]:
    """All levels bottom-up: levels[0] = leaves, levels[-1] = [root]."""
    if not leaf_hashes:
        raise ValueError("empty leaf set")
    levels = [list(leaf_hashes)]
    while len(levels[-1]) > 1:
        cur = levels[-1]
        if len(cur) % 2:
            cur = cur + [cur[-1]]
        levels.append([_parent(cur[i], cur[i + 1]) for i in range(0, len(cur), 2)])
    return levels


def merkle_root(leaf_hashes: Sequence[bytes]) -> bytes:
    return build_merkle_tree(leaf_hashes)[-1][0]


def merkle_proof(levels: List[List[bytes]], index: int) -> List[Tuple[bytes, bool]]:
    """Sibling path for leaf ``index``: (sibling hash, sibling is right)."""
    path = []
    idx = index
    for level in levels[:-1]:
        nodes = level if len(level) % 2 == 0 else level + [level[-1]]
        sib = idx ^ 1
        path.append((nodes[sib], sib > idx))
        idx //= 2
    return path


def verify_merkle_proof(leaf: bytes, path: Sequence[Tuple[bytes, bool]],
                        root: bytes) -> bool:
    h = leaf
    for sibling, _right in path:
        h = _parent(h, sibling)
    return h == root


class MerkleCommitment:
    """Commitment over a recorded denoise trace: timesteps (N,), zs and epss
    (N, ...) as ``pipelines.text2video.generate(record=True)`` returns them.
    Leaves from the native hasher, or with ``use_native=False`` from the
    hashlib loop (the same bytes)."""

    def __init__(self, timesteps, zs, epss, use_native: bool = True):
        if not len(timesteps) == len(zs) == len(epss):
            raise ValueError("timesteps, zs and epss differ in length")
        self.timesteps = np.asarray(timesteps)
        self.zs = zs
        self.epss = epss
        with span("leaf_hash"):
            if use_native:
                self.leaves = sha256_leaves(self.timesteps, zs, epss)
            else:
                self.leaves = [leaf_hash(int(t), zs[i], epss[i])
                               for i, t in enumerate(self.timesteps)]
        with span("merkle_tree"):
            self.levels = build_merkle_tree(self.leaves)

    @property
    def root(self) -> bytes:
        return self.levels[-1][0]

    def proof(self, index: int) -> List[Tuple[bytes, bool]]:
        return merkle_proof(self.levels, index)

    def open(self, index: int):
        """Reveal leaf ``index``: (timestep, z bytes, eps bytes, path)."""
        return (int(self.timesteps[index]), array_bytes(self.zs[index]),
                array_bytes(self.epss[index]), self.proof(index))
