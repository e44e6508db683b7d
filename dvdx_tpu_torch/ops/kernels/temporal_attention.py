"""Frame-axis (temporal) attention: the CUDA kernel and its plain version.

Replaces ``dvdx_tpu/ops/pallas/temporal_attention.py``:
``temporal_attention_posmajor`` (``_temporal_kernel_pm``),
``temporal_attention_fm`` (``_temporal_kernel_fm``) and ``temporal_attention``
(``_temporal_kernel``). One kernel, ``csrc/temporal_attention.cu``, takes a
batch, a frame and a position stride, so the position-major
(B, N, F, H*D) and frame-major (B, F, N, H*D) entry points both launch it.
Persistent CTAs walk over tiles of P positions x one head x all F frames
(``plan``), brought in by TMA through a ring and computed on the tensor
cores; F <= 128 frames and head dims that are multiples of 8 up to 128 (the
JAX fm kernel's limit). Bounded by bytes (about F/2 flops per byte moved).
Float32 inputs launch ``csrc/attention_f32.cu`` (``ops/kernels/
attention_f32``) instead, as the Pallas kernels take float32 too.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import _build
from . import attention_f32

LAUNCHES = 0      # bf16 kernel launches since the last reset (a plain count)
F32_LAUNCHES = 0  # float32 kernel launches since the last reset
MAX_FRAMES = 128
MAX_HEAD_DIM = 128
MAX_STAGES = 4       # ring stages (csrc/temporal_attention.cu MAX_STAGES)
TILE_ROW_BYTES = 16384  # one 64-lane box of a tile's q, k or v: 128 rows of 128 bytes
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on the H100


class Plan(NamedTuple):
    positions: int   # P: positions per tile (one head, all frames)
    frames: int      # F padded to 16 (keys past F masked)
    head_dim: int    # D padded to 16 (lanes past D zero)
    boxes: int       # 64-lane boxes per row
    tiles: int       # B * heads * ceil(N / P)
    stages: int      # ring stages, each q, k and v of one tile
    smem_bytes: int  # dynamic shared memory of the kernel


def plan(b: int, f: int, n: int, heads: int, d: int, layout: str = "fm") -> Plan:
    """The kernel's tiling of q/k/v with F frames, N positions and ``heads``
    heads of width d in either layout ("fm" (B, F, N, H*D), "pm" (B, N, F,
    H*D)): P positions whose frames, padded to 16, make about 128 rows of
    one 64-lane box (64 rows where D takes two boxes), and the most ring
    stages, at most 4, that fit the shared memory. The layout changes only
    the order of a tile's rows, not the plan."""
    if layout not in ("fm", "pm"):
        raise ValueError(f"temporal attention: unknown layout {layout!r}")
    if not 1 <= f <= MAX_FRAMES or d % 8 or not 8 <= d <= MAX_HEAD_DIM or min(b, n, heads) < 1:
        raise ValueError(f"temporal attention: no plan for F={f}, D={d}")
    fpad = -(-f // 16) * 16
    boxes = -(-d // 64)
    p = max(1, TILE_ROW_BYTES // 128 // boxes // fpad)
    stage = 3 * boxes * p * fpad * 128
    stages = MAX_STAGES
    while 1024 + stages * stage + 2 * MAX_STAGES * 8 > SMEM_LIMIT:
        stages -= 1
    return Plan(p, fpad, -(-d // 16) * 16, boxes, b * heads * -(-n // p), stages,
                1024 + stages * stage + 2 * MAX_STAGES * 8)


def check_shape(b: int, f: int, n: int, heads: int, d: int, layout: str = "fm") -> Plan:
    """The kernel's plan for these shapes, or ValueError where the kernel
    does not take them."""
    try:
        return plan(b, f, n, heads, d, layout)
    except ValueError:
        raise ValueError(f"temporal_attention: needs F <= {MAX_FRAMES} and a head dim that is "
                         f"a multiple of 8 <= {MAX_HEAD_DIM} (F={f}, D={d})") from None



def temporal_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             *, heads: int,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Frame-major (B, F, N, heads*D) reference math
    (``temporal_attention_reference``): f32 logits, softmax, probabilities
    cast to v's dtype, f32 P.V, cast to q's dtype."""
    b, f, n, hd = q.shape
    d = hd // heads
    if scale is None:
        scale = d ** -0.5
    qh = q.reshape(b, f, n, heads, d).float()
    kh = k.reshape(b, f, n, heads, d).float()
    vh = v.reshape(b, f, n, heads, d)
    logits = torch.einsum("bfnhd,bgnhd->bnhfg", qh, kh) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bnhfg,bgnhd->bfnhd", probs.float(), vh.float())
    return o.to(q.dtype).reshape(b, f, n, hd)


def _launch(q, k, v, heads: int, scale: Optional[float], frame_axis: int):
    b = q.shape[0]
    f = q.shape[frame_axis]
    n = q.shape[3 - frame_axis]
    hd = q.shape[3]
    d = hd // heads
    if scale is None:
        scale = d ** -0.5
    if k.shape != q.shape or v.shape != q.shape or hd != heads * d:
        raise ValueError("temporal_attention: q, k, v must share one shape "
                         "with heads dividing the last axis")
    if k.device != q.device or v.device != q.device:
        raise ValueError("temporal_attention: q, k, v must share one device")
    pl = check_shape(b, f, n, heads, d, "fm" if frame_axis == 1 else "pm")
    global LAUNCHES, F32_LAUNCHES
    if q.dtype == torch.float32:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        n_axis = 3 - frame_axis
        attention_f32.launch(q, k, v, out, batch=b, n=n, heads=heads, s_q=f, s_k=f, d=d,
                             strides=[(t.stride(0), t.stride(n_axis), t.stride(frame_axis), d)
                                      for t in (q, k, v, out)],
                             scale=scale, what="temporal_attention")
        F32_LAUNCHES += 1
        return out
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError("temporal_attention: the kernel takes bfloat16 or float32")
    if q.stride() != k.stride() or q.stride() != v.stride() \
            or q.stride(3) != 1 or any(st % 8 for st in q.stride()[:3]) \
            or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("temporal_attention: q, k, v need equal strides and "
                         "unit-stride, 16-byte aligned rows")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    sb, sf, sn = q.stride(0), q.stride(frame_axis), q.stride(3 - frame_axis)
    osb, osf, osn = out.stride(0), out.stride(frame_axis), out.stride(3 - frame_axis)
    lib = _build.library("temporal_attention")
    fn = lib.dvdx_temporal_attention
    if fn.argtypes is None:
        ll = ctypes.c_longlong
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ll] * 6
                       + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            b, f, n, heads, d, sb, sf, sn, osb, osf, osn, pl.positions, pl.stages, float(scale),
            _build.stream(q.device))
    _build.check(lib, rc, "temporal_attention")
    LAUNCHES += 1
    return out


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """Frame-major entry point: q/k/v (B, F, N, heads*D) -> same shape. The
    layout the port's ``TransformerTemporal`` produces (rows 4/5 of the TPU
    kernel table). CPU tensors take the plain version; CUDA tensors launch
    the kernel (bf16) or the float32 kernel (float32), or raise."""
    if q.device.type == "cpu":
        return temporal_attention_plain(q, k, v, heads=heads, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"temporal_attention: unsupported device {q.device}")
    return _launch(q, k, v, heads, scale, frame_axis=1)


def temporal_attention_posmajor(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, heads: int,
                                scale: Optional[float] = None) -> torch.Tensor:
    """Position-major entry point: q/k/v (B, N, F, heads*D) -> same shape
    (row 3 of the TPU kernel table)."""
    if q.device.type == "cpu":
        out = temporal_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), heads=heads,
                                       scale=scale)
        return out.transpose(1, 2).contiguous()
    if q.device.type != "cuda":
        raise ValueError(f"temporal_attention: unsupported device {q.device}")
    return _launch(q, k, v, heads, scale, frame_axis=2)
