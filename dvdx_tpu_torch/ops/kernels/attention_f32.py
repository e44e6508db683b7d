"""The float32 attention kernel (``csrc/attention_f32.cu``) shared by the
flash and frame-axis wrappers.

The Pallas flash and frame-axis kernels take float32 as they take bf16; the
port's bf16 kernels run on the tensor cores in bf16, and float32 inputs (the
float32 models) launch this kernel instead, float32-accurate, in one of three
bodies (``csrc/attention_f32.cuh``, which the float32 forms of the fused
tail and block launch too): both products in three TF32 passes on the
tensor cores (x = big + small, each part rounded to TF32; what the split
drops is near float32's own rounding, within 1e-5 of the largest output)
over 64-row query tiles ("mma": bound 3 * 4 Sq Sk D flops at 495 TFLOP/s)
or, for self-attention over fewer than 64 rows (the frame axis), over one
16-row tile a (b, n, h) with the q, k and v rows streamed once ("frames":
bound by bytes); or a warp per query row on the CUDA cores ("rows").
``body`` picks one from shapes, strides and offsets alone. Its callers count
its launches (``F32_LAUNCHES`` in their modules); ``TENSOR_CORE_LAUNCHES``
and ``FRAMES_LAUNCHES`` count the launches of the two tensor-core bodies.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .. import _build

MAX_HEAD_DIM = 128
MMA_ROWS = 64  # query rows of one tensor-core block (MMA_BQ)
TENSOR_CORE_LAUNCHES = 0  # launches of the "mma" body since the last reset
FRAMES_LAUNCHES = 0       # launches of the "frames" body since the last reset
BODY_CODE = {"rows": 0, "mma": 1, "frames": 2}  # csrc/attention_f32.cuh: Body


def takes_tensor_cores(s_q: int, d: int, strides: Sequence[Sequence[int]],
                       offsets: Sequence[int] = ()) -> bool:
    """Whether the tensor-core body runs an attention of ``s_q`` query rows
    of width ``d`` with these element ``strides`` and storage ``offsets``:
    it takes at least one full 64-row query tile, d <= 128 and a multiple of
    4, and every stride and offset a multiple of 4 floats (16-byte rows and
    bases for its 16-byte copies). Every other shape runs the CUDA-core rows.
    Reads shapes and strides only, so every device takes the same body."""
    return s_q >= MMA_ROWS and _packed(d, strides, offsets)


def takes_frames(s_q: int, s_k: int, d: int, strides: Sequence[Sequence[int]],
                 offsets: Sequence[int] = ()) -> bool:
    """Whether the short-sequence body runs it: self-attention over 1 <= s_q
    = s_k < 64 rows (the frame axis), with the widths, strides and offsets
    the tensor-core body takes."""
    return 1 <= s_q < MMA_ROWS and s_q == s_k and _packed(d, strides, offsets)


def _packed(d: int, strides: Sequence[Sequence[int]], offsets: Sequence[int]) -> bool:
    return (d <= MAX_HEAD_DIM and d % 4 == 0
            and all(st % 4 == 0 for sts in strides for st in sts)
            and all(o % 4 == 0 for o in offsets))


def body(s_q: int, s_k: int, d: int, strides: Sequence[Sequence[int]],
         offsets: Sequence[int] = ()) -> str:
    """The body that runs an attention of ``s_q`` query rows over ``s_k``
    keys: "mma" (``takes_tensor_cores``), "frames" (``takes_frames``), else
    the CUDA-core "rows"."""
    if takes_tensor_cores(s_q, d, strides, offsets):
        return "mma"
    return "frames" if takes_frames(s_q, s_k, d, strides, offsets) else "rows"


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, *,
           batch: int, n: int, heads: int, s_q: int, s_k: int, d: int,
           strides: Sequence[Sequence[int]], scale: float, what: str) -> None:
    """out = softmax(q k^T * scale) v over float32 CUDA tensors, addressed
    as b * sb + n * sn + s * ss + h * sh + d with ``strides`` ((sb, sn, ss,
    sh) of q, k, v and out, in elements), on the body ``body`` picks. Raises
    on what the kernel does not take."""
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
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    flat = [int(x) for st in strides for x in st]
    chosen = body(s_q, s_k, d, strides, [t.storage_offset() for t in (q, k, v, out)])
    rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out), batch, n, heads,
            s_q, s_k, d, *flat, float(scale), BODY_CODE[chosen], _build.stream(q.device))
    _build.check(lib, rc, what)
    note_launch(chosen)


def note_launch(chosen: str) -> None:
    """Count a launch of body ``chosen`` (by this module or a fused kernel
    that runs the attention inside)."""
    global TENSOR_CORE_LAUNCHES, FRAMES_LAUNCHES
    TENSOR_CORE_LAUNCHES += chosen == "mma"
    FRAMES_LAUNCHES += chosen == "frames"
