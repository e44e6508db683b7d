"""Flash attention over (B, S, H, D): the CUDA kernel and its plain version.

Replaces ``dvdx_tpu/ops/pallas/flash_attention.py:flash_attention`` (the
``_onepass_kernel`` / ``_flash_kernel`` Pallas bodies). Kernel:
``csrc/flash_attention.cu`` -- one block per (64-query tile, batch*head),
tensor-core QK^T and P.V with an f32 online softmax, Q/K/V read by strides
from the (B, S, H, D) layout. Bounded by tensor-core operations at the UNet's
spatial shapes (S = 2880 / 720, D = 64).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

LAUNCHES = 0  # kernel launches since the last reset (a plain count)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v with f32 logits and softmax, probabilities
    cast to v's dtype before the f32-accumulated P.V (the reference's
    ``_xla_attention`` math). q: (B, S, H, D), k/v: (B, T, H, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs.float(), v.float())
    return out.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal self-attention over (B, S, H, D). CPU tensors take the plain
    version; CUDA tensors launch the kernel (bf16, D % 8 == 0, D <= 128,
    unit stride on D) or raise."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, s, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_attention: q, k, v must share (B, S, H, D)")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must share one device")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError("flash_attention: the kernel takes bfloat16")
    if d % 8 or d > 128:
        raise ValueError(f"flash_attention: head dim {d} not a multiple of 8 <= 128")
    for t in (q, k, v):
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError("flash_attention: rows must be unit-stride and "
                             "16-byte aligned")
    global LAUNCHES
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lib = _build.library("flash_attention")
    fn = lib.dvdx_flash_attention
    if fn.argtypes is None:
        ll = ctypes.c_longlong
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ll] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            b, h, s, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), _build.stream(q.device))
    _build.check(lib, rc, "flash_attention")
    LAUNCHES += 1
    return out
