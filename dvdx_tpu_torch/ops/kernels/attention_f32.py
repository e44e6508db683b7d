"""The float32 attention kernel (``csrc/attention_f32.cu``) shared by the
flash and frame-axis wrappers.

The Pallas flash and frame-axis kernels take float32 as they take bf16; the
port's bf16 kernels run on the tensor cores, and float32 inputs (the float32
test models) launch this kernel instead: a warp per query row over tiles of
32 keys staged in shared memory, one key a lane, an f32 online softmax, on
the CUDA cores (``csrc/attention_f32.cuh``, which the float32 forms of the
fused tail and block launch too). Its callers count
its launches (``F32_LAUNCHES`` in their modules).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .. import _build

MAX_HEAD_DIM = 128


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, *,
           batch: int, n: int, heads: int, s_q: int, s_k: int, d: int,
           strides: Sequence[Sequence[int]], scale: float, what: str) -> None:
    """out = softmax(q k^T * scale) v over float32 CUDA tensors, addressed
    as b * sb + n * sn + s * ss + h * sh + d with ``strides`` ((sb, sn, ss,
    sh) of q, k, v and out, in elements). Raises on what the kernel does not
    take."""
    if any(t.dtype != torch.float32 for t in (q, k, v, out)):
        raise ValueError(f"{what}: the float32 kernel takes float32")
    if not 1 <= d <= MAX_HEAD_DIM or -(-s_q // 8) * heads * batch * n >= 2 ** 31:
        raise ValueError(f"{what}: the float32 kernel takes D <= {MAX_HEAD_DIM} "
                         f"(D={d}) and ceil(Sq/8)*H*B*N < 2^31")
    if any(t.stride(-1) != 1 for t in (q, k, v, out)):
        raise ValueError(f"{what}: rows must be unit-stride")
    lib = _build.library("attention_f32")
    fn = lib.dvdx_attention_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 16
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    flat = [int(x) for st in strides for x in st]
    rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out), batch, n, heads,
            s_q, s_k, d, *flat, float(scale), _build.stream(q.device))
    _build.check(lib, rc, what)
