"""Fused spatial transformer tail: the CUDA kernel and its plain version.

Replaces ``dvdx_tpu/ops/pallas/spatial_tail.py:fused_spatial_tail`` (its
``_tail_kernel`` and ``_tail_kernel_streamed`` bodies): everything of a
BasicTransformerBlock after attn1's P.V output -- the out-projection and
residual, LN2, the cross-attention over the text context, its
out-projection and residual, LN3 and the GEGLU feed-forward with its
residual -- in the TPU kernel's rounding order ((x + mm) + b, where the
unfused branch computes x + (mm + b)), so the fused configuration is a step
program of its own.

Kernel: ``csrc/spatial_tail.cu``, three launches with nothing between them
-- the row-local chain up to LN3 on 32-row tiles held in shared memory
(weights stream from L2: they do not fit shared memory), then the GEGLU
feed-forward as the two wgmma products of ``csrc/geglu_gemm.cuh``, the second
with the residual epilogue; the inner tensor goes through a (rows, I)
scratch. Bounded by tensor-core operations at the UNet's level 0; it takes
C <= 768 (C % 64 == 0) and I % 128 == 0.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from .. import _build
from .fused_math import dense, geglu_residual, layer_norm

LAUNCHES = 0  # calls that launched the kernel (its three launches) since the last reset
MAX_DIM = 768
MAX_CONTEXT = 512
KEYS = ("o1_w", "o1_b", "ln2_s", "ln2_b", "q2_w", "o2_w", "o2_b",
        "ln3_s", "ln3_b", "ffi_w", "ffi_b", "ffo_w", "ffo_b")


def _scale(params: Dict[str, torch.Tensor], heads: int,
           scale: Optional[float]) -> float:
    return (params["q2_w"].shape[0] // heads) ** -0.5 if scale is None else scale


def fused_spatial_tail_plain(x: torch.Tensor, o1: torch.Tensor,
                             ctx_k: torch.Tensor, ctx_v: torch.Tensor,
                             params: Dict[str, torch.Tensor], *, heads: int,
                             scale: Optional[float] = None,
                             eps: float = 1e-5) -> torch.Tensor:
    """The TPU kernel's math in tensor ops: x (N, S, C), o1 (N, S, HD1),
    ctx_k / ctx_v (N, T, HD); f32 logits, probabilities normalised and
    rounded to x's dtype before P.V."""
    p = params
    dt = x.dtype
    scale = _scale(p, heads, scale)
    n, s, _ = x.shape
    hd = p["q2_w"].shape[0]
    d = hd // heads
    x1 = (x + dense(o1.to(dt), p["o1_w"])) + p["o1_b"].to(dt)
    q = dense(layer_norm(x1, p["ln2_s"], p["ln2_b"], eps), p["q2_w"])
    qh = q.view(n, s, heads, d).float()
    kh = ctx_k.to(dt).reshape(n, -1, heads, d).float()
    vh = ctx_v.to(dt).reshape(n, -1, heads, d).float()
    logits = torch.einsum("nshd,nthd->nhst", qh, kh) * scale
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = (e / e.sum(dim=-1, keepdim=True)).to(dt)
    ao = torch.einsum("nhst,nthd->nshd", probs.float(), vh).to(dt).reshape(n, s, hd)
    x2 = (x1 + dense(ao, p["o2_w"])) + p["o2_b"].to(dt)
    h = layer_norm(x2, p["ln3_s"], p["ln3_b"], eps)
    return geglu_residual(h, x2, p["ffi_w"], p["ffi_b"], p["ffo_w"], p["ffo_b"])


def fused_spatial_tail(x: torch.Tensor, o1: torch.Tensor, ctx_k: torch.Tensor,
                       ctx_v: torch.Tensor, params: Dict[str, torch.Tensor], *,
                       heads: int, scale: Optional[float] = None,
                       eps: float = 1e-5) -> torch.Tensor:
    """A BasicTransformerBlock's post-attn1 tail. x: (N, S, C) block input;
    o1: (N, S, HD1) attn1's P.V output before its out-projection; ctx_k /
    ctx_v: (N, T, HD) the context projected by attn2's to_k / to_v. params:
    the flat dict of ``KEYS`` with weights in nn.Linear's (out, in) layout.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16 x; parameters cast to bf16) or raise."""
    if x.device.type == "cpu":
        return fused_spatial_tail_plain(x, o1, ctx_k, ctx_v, params, heads=heads,
                                        scale=scale, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_spatial_tail: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError("fused_spatial_tail: the kernel takes bfloat16")
    n, s, c = x.shape
    hd1, hd, t = o1.shape[-1], params["q2_w"].shape[0], ctx_k.shape[1]
    inner = params["ffi_w"].shape[0] // 2
    if (c % 64 or c > MAX_DIM or hd1 % 16 or hd1 > MAX_DIM or hd % 16
            or hd > MAX_DIM or hd % heads or not 1 <= t <= MAX_CONTEXT
            or inner % 128 or o1.shape[:2] != (n, s)
            or ctx_k.shape != (n, t, hd) or ctx_v.shape != (n, t, hd)):
        raise ValueError(f"fused_spatial_tail: unsupported shapes x {tuple(x.shape)}, "
                         f"o1 {tuple(o1.shape)}, ctx {tuple(ctx_k.shape)}")
    ops = [x, o1, ctx_k, ctx_v] + [params[k] for k in KEYS]
    if any(a.device != x.device for a in ops):
        raise ValueError("fused_spatial_tail: every operand must be on x's device")
    ops = [a.to(torch.bfloat16).contiguous() for a in ops]
    if any(a.data_ptr() % 16 for a in ops):
        raise ValueError("fused_spatial_tail: operands must be 16-byte aligned")
    x2, h = torch.empty_like(ops[0]), torch.empty_like(ops[0])
    ff_inner = torch.empty((n * s, inner), dtype=x2.dtype, device=x2.device)
    out = torch.empty_like(ops[0])
    lib = _build.library("spatial_tail")
    fn = lib.dvdx_spatial_tail
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 21 + [ctypes.c_int] * 8
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    rc = fn(*(_build.ptr(a) for a in ops + [x2, h, ff_inner, out]), n * s, s, c, hd1, hd,
            t, heads, inner, float(_scale(params, heads, scale)), float(eps),
            _build.stream(x.device))
    _build.check(lib, rc, "fused_spatial_tail")
    global LAUNCHES
    LAUNCHES += 1
    return out
