"""ctypes bindings for the native SHA-256 of the Merkle commitment
(``csrc/merkle.cpp``).

The port's copy of ``dvdx_tpu/utils/native.py``, with the same three entry
points over the same bytes. The library is built with ``g++`` at first use
into ``BUILD_DIR``; its name carries a hash of the source and the flags, and
it is compiled to a temporary file that is renamed into place, so processes
that build at once (test workers, services starting together) never load a
half-written file and need no lock between them. A failed build raises with
the compiler's output, and the next call builds again: nothing is remembered
across calls and nothing falls back to Python. The plain version the library
is held against is the hashlib loop of ``verify.merkle.leaf_hash``.

No ``-march=native``: a host that shares the build directory with another
(the name does not depend on the CPU) must be able to load the library.
SHA-NI is chosen at run time from CPUID, as in the JAX package's build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "merkle.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_libs: Dict[Path, ctypes.CDLL] = {}


def _target() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdvdx_merkle-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The library's path, compiling it first where it is not there yet.
    Raises RuntimeError with the compiler's output if the build fails."""
    target = _target()
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except OSError as e:
        raise RuntimeError(f"building {SOURCE.name}: cannot run {CXX!r}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed ({' '.join(cmd)}, exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target


def library() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    with _lock:
        target = _target()
        lib = _libs.get(target)
        if lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.dvdx_sha256_leaves.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int]
            lib.dvdx_sha256_leaves.restype = None
            lib.dvdx_merkle_root.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                             ctypes.c_char_p]
            lib.dvdx_merkle_root.restype = None
            lib.dvdx_sha256.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p]
            lib.dvdx_sha256.restype = None
            _libs[target] = lib
        return lib


def host_array(x) -> np.ndarray:
    """A C-contiguous host array holding the raw little-endian bytes of a
    torch tensor or numpy array in its logical (row-major) order; bfloat16
    tensors by their 16-bit patterns. No copy where ``x`` is already a
    contiguous CPU tensor or array."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.ascontiguousarray(x)


def sha256_leaves(timesteps, zs, epss, n_threads: int = 0) -> List[bytes]:
    """Leaf hashes sha256(t as big-endian u16 || z_i bytes || eps_i bytes),
    one a step: the bytes of ``verify.merkle.leaf_bytes``, hashed in place
    from the (N, ...) stacks (numpy arrays or torch tensors of any dtype),
    threaded across steps (``n_threads`` 0: up to 8)."""
    ts = np.asarray(timesteps).reshape(-1)
    n = ts.shape[0]
    if n == 0:
        return []
    if ts.min() < 0 or ts.max() > 0xFFFF:
        raise OverflowError("a timestep does not fit in an unsigned 16-bit integer")
    ts = np.ascontiguousarray(ts, dtype=np.uint16)
    za, ea = host_array(zs), host_array(epss)
    if za.shape[:1] != (n,) or ea.shape[:1] != (n,):
        raise ValueError(f"{n} timesteps, z of shape {za.shape}, eps of shape {ea.shape}")
    bpt = za.nbytes // n
    if ea.nbytes // n != bpt:
        raise ValueError("z/eps byte size mismatch")
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    out = ctypes.create_string_buffer(32 * n)
    library().dvdx_sha256_leaves(ts.ctypes.data, za.ctypes.data, ea.ctypes.data,
                                 n, bpt, out, n_threads)
    raw = out.raw
    return [raw[32 * i: 32 * (i + 1)] for i in range(n)]


def merkle_root(leaves: List[bytes]) -> bytes:
    """Root of the sorted-pair tree over 32-byte leaves, odd nodes
    duplicated (``verify.merkle.build_merkle_tree``'s)."""
    if not leaves:
        raise ValueError("empty leaf set")
    if any(len(leaf) != 32 for leaf in leaves):
        raise ValueError("a leaf is not 32 bytes")
    out = ctypes.create_string_buffer(32)
    library().dvdx_merkle_root(b"".join(leaves), len(leaves), out)
    return out.raw


def sha256(data) -> bytes:
    """sha256 of a bytes-like object."""
    buf = np.frombuffer(data, dtype=np.uint8)
    out = ctypes.create_string_buffer(32)
    library().dvdx_sha256(buf.ctypes.data, buf.nbytes, out)
    return out.raw
