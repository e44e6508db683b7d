"""Fused GEGLU feed-forward: the CUDA kernel and its plain version.

Replaces ``dvdx_tpu/ops/pallas/geglu_ff.py:geglu_ff`` (``_geglu_kernel``).
Kernel: ``csrc/geglu_ff.cu`` -- one block per token tile walks the inner
dimension in 64-wide chunks, so the 8x-width inner tensor never reaches
device memory; the (tile x C) f32 output accumulator stays on chip for the
whole inner sweep. Value and gate are rounded to the activation dtype where
the JAX kernel rounds them; GELU is the exact-erf form with CUDA's ``erff``
(the plain version uses ``torch.erf``; the JAX kernel's A&S 7.1.26 ``_erf`` is
a TPU workaround for a missing primitive). Bounded by tensor-core operations
at the UNet's token counts.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

LAUNCHES = 0  # kernel launches since the last reset (a plain count)
WIDTHS = (64, 128, 320, 640, 1280)  # model widths the kernel is built for


def geglu_ff_plain(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
                   w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    """((x Wv + bv) * gelu(x Wg + bg)) Wo + bo with f32 products of
    x.dtype-rounded operands and the kernel's rounding points. Weights use
    nn.Linear's layout: w_in (2I, C) value rows first, w_out (C, I)."""
    dt = x.dtype
    inner = w_in.shape[0] // 2
    hg = x.float() @ w_in.to(dt).float().t() + b_in.to(dt).float()
    val = hg[..., :inner].to(dt).float()
    gate = hg[..., inner:].to(dt).float()
    h = (val * (0.5 * gate * (1.0 + torch.erf(gate * (1.0 / math.sqrt(2.0))))))
    y = h.to(dt).float() @ w_out.to(dt).float().t() + b_out.to(dt).float()
    return y.to(dt)


def geglu_ff(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
             w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    """GEGLU MLP over the last axis of x (..., C). CPU tensors take the plain
    version; CUDA tensors launch the kernel (bf16, C in WIDTHS) or raise.
    Weights are cast to x's dtype, as nn.Dense(dtype=...) does."""
    if x.device.type == "cpu":
        return geglu_ff_plain(x, w_in, b_in, w_out, b_out)
    if x.device.type != "cuda":
        raise ValueError(f"geglu_ff: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError("geglu_ff: the kernel takes bfloat16")
    c = x.shape[-1]
    inner = w_in.shape[0] // 2
    if c not in WIDTHS or inner % 64 or w_in.shape != (2 * inner, c) \
            or w_out.shape != (c, inner) or b_in.shape != (2 * inner,) \
            or b_out.shape != (c,):
        raise ValueError(f"geglu_ff: unsupported width C={c}, inner={inner}")
    if any(t.device != x.device for t in (w_in, b_in, w_out, b_out)):
        raise ValueError("geglu_ff: x and the weights must share one device")
    dt = x.dtype
    xt = x.reshape(-1, c).contiguous()
    wi, bi = w_in.to(dt).contiguous(), b_in.to(dt).contiguous()
    wo, bo = w_out.to(dt).contiguous(), b_out.to(dt).contiguous()
    out = torch.empty_like(xt)
    lib = _build.library("geglu_ff")
    fn = lib.dvdx_geglu_ff
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    rc = fn(_build.ptr(xt), _build.ptr(wi), _build.ptr(bi), _build.ptr(wo),
            _build.ptr(bo), _build.ptr(out), xt.shape[0], c, inner,
            _build.stream(x.device))
    _build.check(lib, rc, "geglu_ff")
    global LAUNCHES
    LAUNCHES += 1
    return out.reshape(x.shape)
