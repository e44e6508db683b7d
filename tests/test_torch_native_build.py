"""The JAX package's native hasher, built once before any test runs, and the
port's Merkle root against it.

``dvdx_tpu/utils/native.py`` compiles ``build/libdvdx_native.so`` with g++
on first use in each process, without a lock between processes, and a
process that loads the file while another rewrites it marks the library
failed for its whole life; the JAX ``MerkleCommitment`` then raises on every
commitment in that process (ROADMAP §3). The test workers all import this
module while they collect, before any of them runs a test, so here each one
takes an exclusive lock on ``build/native_build.lock`` and loads the library
inside it: the first worker builds it, the others load the finished file.
A worker whose earlier load (``tests/test_native.py`` asks at import) met a
file being written retries here, inside the lock, until the writers are
done. The JAX package itself is not changed.
"""

import fcntl
import hashlib
import os
import time

import numpy as np
import torch

from dvdx_tpu.utils import native
from dvdx_tpu.verify.merkle import MerkleCommitment as JaxMerkleCommitment
from dvdx_tpu_torch.verify.merkle import MerkleCommitment, leaf_hash

BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")
RETRY_S = 30.0  # g++ of native/merkle.cpp takes seconds; other writers end within this


def _load_native_under_lock() -> bool:
    os.makedirs(BUILD, exist_ok=True)
    with open(os.path.join(BUILD, "native_build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            deadline = time.monotonic() + RETRY_S
            while True:
                native._build_failed = False  # a failure seen while another process wrote the file
                if native.available() or time.monotonic() > deadline:
                    return native.available()
                time.sleep(1.0)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


NATIVE = _load_native_under_lock()


def test_port_merkle_root_equals_the_jax_native_root():
    """Leaves and root: the port's hashlib commitment against the JAX
    package's native one (the C++ sha256 of t_be16 || z || eps) on the same
    bf16 latents, exactly."""
    assert NATIVE, "the native library did not build or load"
    rng = np.random.default_rng(12)
    n = 9
    ts = np.array([961 - 40 * i for i in range(n)], np.uint16)
    zs = torch.from_numpy(rng.normal(size=(n, 1, 4, 8, 8, 4)).astype(np.float32)).bfloat16()
    epss = torch.from_numpy(rng.normal(size=(n, 1, 4, 8, 8, 4)).astype(np.float32)).bfloat16()
    z16, e16 = (t.view(torch.int16).numpy() for t in (zs, epss))
    native_leaves = native.sha256_leaves(ts, z16, e16)
    port = MerkleCommitment(ts, zs, epss)
    assert port.leaves == native_leaves
    assert [leaf_hash(int(t), zs[i], epss[i]) for i, t in enumerate(ts)] == native_leaves
    assert port.root == JaxMerkleCommitment(ts, z16, e16).root
    assert native.sha256(b"dvdx") == hashlib.sha256(b"dvdx").digest()
