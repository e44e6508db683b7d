"""Frame-axis (temporal) attention: the CUDA kernel and its plain version.

Replaces ``dvdx_tpu/ops/pallas/temporal_attention.py``:
``temporal_attention_posmajor`` (``_temporal_kernel_pm``),
``temporal_attention_fm`` (``_temporal_kernel_fm``) and ``temporal_attention``
(``_temporal_kernel``). One kernel, ``csrc/temporal_attention.cu``, takes a
batch, a frame and a position stride, so the position-major
(B, N, F, H*D) and frame-major (B, F, N, H*D) entry points both launch it.
One block per (batch, position, head) unit; F <= 32 frames held in shared
memory. Bounded by bytes (about F/2 flops per byte moved).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

LAUNCHES = 0  # kernel launches since the last reset (a plain count)


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
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError("temporal_attention: the kernel takes bfloat16")
    if f > 32 or d > 128 or d % 8:
        raise ValueError(f"temporal_attention: needs F <= 32 and head dim a "
                         f"multiple of 8 <= 128 (F={f}, D={d})")
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
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            b, f, n, heads, d, sb, sf, sn, osb, osf, osn, float(scale),
            _build.stream(q.device))
    _build.check(lib, rc, "temporal_attention")
    global LAUNCHES
    LAUNCHES += 1
    return out


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """Frame-major entry point: q/k/v (B, F, N, heads*D) -> same shape. The
    layout the port's ``TransformerTemporal`` produces (rows 4/5 of the TPU
    kernel table). CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
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
