"""The Proof-of-Inference commitment with ``hashlib``: leaf = sha256(t as a
big-endian u16 || z bytes || eps bytes), z and eps as little-endian
bfloat16 in channel-last (F, h, w, C) order; a parent hashes its sorted
pair of children; an odd node is paired with itself. It imports neither JAX
nor anything of the program."""

import hashlib
from typing import List, Sequence, Tuple


def leaf_hash(t: int, z_bytes: bytes, eps_bytes: bytes) -> bytes:
    return hashlib.sha256(int(t).to_bytes(2, "big") + z_bytes + eps_bytes).digest()


def _parent(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(min(a, b) + max(a, b)).digest()


def root(leaves: Sequence[bytes]) -> bytes:
    level = list(leaves)
    while len(level) > 1:
        if len(level) % 2:
            level.append(level[-1])
        level = [_parent(level[i], level[i + 1]) for i in range(0, len(level), 2)]
    return level[0]


def verify_path(leaf: bytes, path: List[Tuple[bytes, bool]], expected_root: bytes) -> bool:
    h = leaf
    for sibling, _right in path:
        h = _parent(h, bytes(sibling))
    return h == expected_root
