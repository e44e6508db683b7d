"""Flash attention: the CUDA kernel and its plain versions, in two layouts.

Replaces ``dvdx_tpu/ops/pallas/flash_attention.py``:

* ``flash_attention`` over (B, S, H, D) (the ``_onepass_kernel`` /
  ``_flash_kernel`` Pallas bodies);
* ``flash_attention_mh`` over the projections' head-strip layout
  (B, S, H * dp), dp = roundup128(head_dim) with zero pad lanes, and a key
  length of its own (the ``_onepass_mh_kernel`` / ``_flash_mh_kernel``
  bodies), with ``pad_head_columns`` / ``pad_head_rows``.

One kernel, ``csrc/flash_attention.cu``, serves both: one block per (128-query
tile, batch*head), K/V tiles brought in by TMA through a ring in shared
memory, QK^T and P.V on wgmma with an f32 online softmax in between, Q/K/V
and the output addressed by strides, a ragged key tail masked. On Hopper the
128-lane strips buy nothing, so the mh entry point launches it on strided
views of each strip's first head_dim lanes; the pad lanes of its output come
from one ``torch.zeros`` allocation. Bounded by tensor-core operations at the
UNet's spatial shapes (S = 2880 / 720, D = 64). ``flash_attention`` on
float32 inputs launches ``csrc/attention_f32.cu`` (``ops/kernels/
attention_f32``) instead, as the Pallas kernel takes float32 too.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from . import attention_f32

LAUNCHES = 0     # flash_attention kernel launches since the last reset
F32_LAUNCHES = 0  # flash_attention launches of the float32 kernel
MH_LAUNCHES = 0  # flash_attention_mh kernel launches since the last reset
LANES = 128      # the TPU's lane tile: head strips are padded to it


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


def _check_operands(name, q, k, v):
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k, v must share one device")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"{name}: the kernel takes bfloat16")
    for t in (q, k, v):
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: rows must be unit-stride and 16-byte aligned")


def _launch(q, k, v, out, q_scale: float, scale: float) -> None:
    """The kernel on (B, S, H, D) views q, out and (B, Sk, H, D) views k, v."""
    b, s, h, d = q.shape
    if d % 8 or d > 128:
        raise ValueError(f"flash_attention: head dim {d} not a multiple of 8 <= 128")
    lib = _build.library("flash_attention")
    fn = lib.dvdx_flash_attention
    if fn.argtypes is None:
        ll = ctypes.c_longlong
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ll] * 12
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            b, h, s, k.shape[1], d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], float(q_scale), float(scale),
            _build.stream(q.device))
    _build.check(lib, rc, "flash_attention")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal self-attention over (B, S, H, D). CPU tensors take the plain
    version; CUDA tensors launch the kernel (bf16, D % 8 == 0, D <= 128,
    unit stride on D), or the float32 kernel (float32, D <= 128), or
    raise."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_attention: q, k, v must share (B, S, H, D)")
    global LAUNCHES, F32_LAUNCHES
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.dtype == torch.float32 and k.device == q.device and v.device == q.device:
        b, s, h, d = q.shape
        attention_f32.launch(q, k, v, out, batch=b, n=1, heads=h, s_q=s, s_k=s, d=d,
                             strides=[(t.stride(0), 0, t.stride(1), t.stride(2))
                                      for t in (q, k, v, out)],
                             scale=scale, what="flash_attention")
        F32_LAUNCHES += 1
        return out
    _check_operands("flash_attention", q, k, v)
    _launch(q, k, v, out, 1.0, scale)
    LAUNCHES += 1
    return out


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pad_head_columns(w: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """(C, heads*head_dim) -> (C, heads*dp): zero-widen each head's column
    strip to dp = roundup128(head_dim) (the JAX package's kernel layout, in
    which a projection's matmul emits the padded strips)."""
    dp = _ceil_to(head_dim, LANES)
    if dp == head_dim:
        return w
    w3 = w.reshape(w.shape[0], heads, head_dim)
    return torch.nn.functional.pad(w3, (0, dp - head_dim)).reshape(w.shape[0], heads * dp)


def pad_head_rows(w: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """(heads*head_dim, C) -> (heads*dp, C): zero rows aligned with the padded
    output lanes."""
    dp = _ceil_to(head_dim, LANES)
    if dp == head_dim:
        return w
    w3 = w.reshape(heads, head_dim, w.shape[1])
    return torch.nn.functional.pad(w3, (0, 0, 0, dp - head_dim)).reshape(heads * dp, w.shape[1])


def _head_views(x: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """(B, S, heads*dp) -> the (B, S, heads, head_dim) view of each strip's
    first head_dim lanes."""
    b, s, hdp = x.shape
    return x.view(b, s, heads, hdp // heads)[..., :head_dim]


def flash_attention_mh_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             *, heads: int, head_dim: int,
                             scale: Optional[float] = None) -> torch.Tensor:
    """The one-pass mh kernel's math: q * scale rounded to q's dtype, f32
    logits, p = exp(s - max) rounded to v's dtype, f32 P.V divided by the f32
    sum, zero pad lanes. q: (B, Sq, heads*dp), k/v: (B, Sk, heads*dp)."""
    if scale is None:
        scale = head_dim ** -0.5
    qh = (_head_views(q, heads, head_dim).float() * scale).to(q.dtype).float()
    kh = _head_views(k, heads, head_dim).float()
    vh = _head_views(v, heads, head_dim)
    logits = torch.einsum("bshd,bthd->bhst", qh, kh)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhst,bthd->bshd", e.to(v.dtype).float(), vh.float())
    o = o / e.sum(dim=-1).transpose(1, 2)[..., None]
    out = torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    _head_views(out, heads, head_dim).copy_(o.to(q.dtype))
    return out


def flash_attention_mh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       heads: int, head_dim: int,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Attention in the projections' head-strip layout: q (B, Sq, heads*dp),
    k/v (B, Sk, heads*dp), dp = roundup128(head_dim), zero pad lanes in and
    out; Sk may differ from Sq (cross-attention). CPU tensors take the plain
    version; CUDA tensors launch the flash kernel on each strip's first
    head_dim lanes (bf16, head_dim % 8 == 0) or raise."""
    if scale is None:
        scale = head_dim ** -0.5
    if q.device.type == "cpu":
        return flash_attention_mh_plain(q, k, v, heads=heads, head_dim=head_dim,
                                        scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_mh: unsupported device {q.device}")
    dp = _ceil_to(head_dim, LANES)
    if q.shape[-1] != heads * dp or k.shape[-1] != heads * dp \
            or v.shape != k.shape or k.shape[0] != q.shape[0]:
        raise ValueError(f"flash_attention_mh: need q (B, Sq, {heads * dp}) and "
                         f"k, v (B, Sk, {heads * dp})")
    qv, kv, vv = (_head_views(t, heads, head_dim) for t in (q, k, v))
    _check_operands("flash_attention_mh", qv, kv, vv)
    global MH_LAUNCHES
    out = torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    _launch(qv, kv, vv, _head_views(out, heads, head_dim), scale, 1.0)
    MH_LAUNCHES += 1
    return out
