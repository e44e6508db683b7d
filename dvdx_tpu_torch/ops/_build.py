"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). All sources are compiled in parallel at
first use, into ``build/torch_kernels/`` beside the package; the library name
carries a hash of the sources and flags, so an edited source is never served
from a stale build.

Every exported launcher takes raw device pointers (``c_void_p``), sizes and
strides, and the CUDA stream to launch on, and returns
``cudaGetLastError()`` after its launches; :func:`check` raises on a nonzero
code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("flash_attention", "temporal_attention", "geglu_ff", "groupnorm",
           "spatial_tail", "temporal_block", "attention_f32", "spatial_tail_f32",
           "temporal_block_f32", "bias_epilogue", "qk_norm_rope", "dit_epilogue")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# per-source build record: seconds, ptxas report (registers / spills)
BUILD_LOG: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, dict]:
    """Compile every source that has no current build, one nvcc per source,
    all started together. Returns BUILD_LOG. Raises with nvcc's output if a
    source fails to compile."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in SOURCES:
            target = _target(name)
            if target.exists():
                BUILD_LOG.setdefault(name, {"seconds": 0.0, "ptxas": "cached",
                                            "path": str(target)})
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True),
                           tmp, target, time.perf_counter())
        failed = []
        for name, (proc, tmp, target, t0) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                               "ptxas": out, "path": str(target)}
            if proc.returncode != 0:
                failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{out}")
            else:
                os.replace(tmp, target)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        return BUILD_LOG


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building all sources first if
    needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all()
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_target(name)))
            lib.dvdx_error_string.argtypes = [ctypes.c_int]
            lib.dvdx_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if rc != 0:
        msg = lib.dvdx_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}: {msg}")


def unfilled(shape, dtype, device):
    """A new tensor for a kernel to write in full. ``torch.empty`` fills new
    memory with NaN while deterministic algorithms are on (``enable_
    determinism``): a pass over the whole output on the card that the
    kernel's own writes make useless. A storage of the same size is not
    filled."""
    import math

    import torch

    n = math.prod(shape) * dtype.itemsize
    storage = torch.UntypedStorage(n, device=device)
    return torch.empty(0, dtype=dtype, device=device).set_(storage, 0, tuple(shape))


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
