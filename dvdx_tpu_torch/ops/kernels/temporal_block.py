"""Fused temporal transformer block: the CUDA kernel and its plain version.

Replaces ``dvdx_tpu/ops/pallas/temporal_block.py:fused_temporal_block``
(``_block_kernel``): the whole ``_TemporalBlock`` on frame-major
(B, F, N, C) -- LN1 and frame-axis self-attention, LN2 and the second
frame-axis self-attention (diffusers double_self_attention), LN3 and the
GEGLU feed-forward, each with its residual -- in the TPU kernel's rounding
order: x + (mm + b) after each attention, the unnormalised probabilities
exp(s - max) rounded to bf16 before P.V and the sum divided after, and the FF
output bias added in float32 before its one rounding.

Kernel: ``csrc/temporal_block.cu``, two launches with nothing between them --
both attention sub-blocks and LN3 on 32-row tiles (P = 32 / F positions x F
frames, gathered by the frame stride; the F x F attention runs per
position), then the GEGLU tile of ``csrc/geglu_body.cuh`` with a residual
epilogue. Bounded by tensor-core operations at the UNet's level 0; it takes
C <= 384 (C % 64 == 0) and F <= 32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from .. import _build
from .fused_math import dense, geglu_residual, layer_norm

LAUNCHES = 0  # calls that launched the kernel (its two launches) since the last reset
MAX_DIM = 384
MAX_FRAMES = 32
KEYS = ("ln1_s", "ln1_b", "q1", "k1", "v1", "o1_w", "o1_b",
        "ln2_s", "ln2_b", "q2", "k2", "v2", "o2_w", "o2_b",
        "ln3_s", "ln3_b", "ffi_w", "ffi_b", "ffo_w", "ffo_b")


def _frame_attention(x: torch.Tensor, p: Dict[str, torch.Tensor], i: int,
                     heads: int, scale: float, eps: float) -> torch.Tensor:
    """x + (bf16(Attn(LN(x)) Wo^T) + bo) over the frame axis of (B, F, N, C)."""
    dt = x.dtype
    b, f, n, c = x.shape
    d = c // heads
    h = layer_norm(x, p[f"ln{i}_s"], p[f"ln{i}_b"], eps)
    qh, kh, vh = (dense(h, p[f"{w}{i}"]).view(b, f, n, heads, d).float()
                  for w in "qkv")
    logits = torch.einsum("bfnhd,bgnhd->bnhfg", qh, kh) * scale
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    og = torch.einsum("bnhfg,bgnhd->bfnhd", e.to(dt).float(), vh)
    o = (og / e.sum(dim=-1).permute(0, 3, 1, 2)[..., None]).to(dt).reshape(b, f, n, c)
    return x + (dense(o, p[f"o{i}_w"]) + p[f"o{i}_b"].to(dt))


def fused_temporal_block_plain(x: torch.Tensor, params: Dict[str, torch.Tensor],
                               *, heads: int, scale: Optional[float] = None,
                               eps: float = 1e-5) -> torch.Tensor:
    """The TPU kernel's math in tensor ops on x (B, F, N, C)."""
    if scale is None:
        scale = (x.shape[-1] // heads) ** -0.5
    x = _frame_attention(x, params, 1, heads, scale, eps)
    x = _frame_attention(x, params, 2, heads, scale, eps)
    h = layer_norm(x, params["ln3_s"], params["ln3_b"], eps)
    return geglu_residual(h, x, params["ffi_w"], params["ffi_b"],
                          params["ffo_w"], params["ffo_b"])


def fused_temporal_block(x: torch.Tensor, params: Dict[str, torch.Tensor], *,
                         heads: int, scale: Optional[float] = None,
                         eps: float = 1e-5) -> torch.Tensor:
    """A whole _TemporalBlock on x (B, F, N, C) frame-major. params: the flat
    dict of ``KEYS`` with weights in nn.Linear's (out, in) layout. CPU tensors
    take the plain version; CUDA tensors launch the kernel (bf16 x;
    parameters cast to bf16) or raise."""
    if x.device.type == "cpu":
        return fused_temporal_block_plain(x, params, heads=heads, scale=scale,
                                          eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_temporal_block: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError("fused_temporal_block: the kernel takes bfloat16")
    b, f, n, c = x.shape
    inner = params["ffi_w"].shape[0] // 2
    if c % 64 or c > MAX_DIM or c % heads or f > MAX_FRAMES or inner % 64 \
            or params["q1"].shape != (c, c):
        raise ValueError(f"fused_temporal_block: unsupported shape {tuple(x.shape)} "
                         f"with {heads} heads")
    ops = [x] + [params[k] for k in KEYS]
    if any(a.device != x.device for a in ops):
        raise ValueError("fused_temporal_block: every operand must be on x's device")
    ops = [a.to(torch.bfloat16).contiguous() for a in ops]
    if any(a.data_ptr() % 16 for a in ops):
        raise ValueError("fused_temporal_block: operands must be 16-byte aligned")
    x_mid, h = torch.empty_like(ops[0]), torch.empty_like(ops[0])
    out = torch.empty_like(ops[0])
    lib = _build.library("temporal_block")
    fn = lib.dvdx_temporal_block
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 24 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    scale = (c // heads) ** -0.5 if scale is None else scale
    rc = fn(*(_build.ptr(a) for a in ops + [x_mid, h, out]), b, f, n, c, heads,
            inner, float(scale), float(eps), _build.stream(x.device))
    _build.check(lib, rc, "fused_temporal_block")
    global LAUNCHES
    LAUNCHES += 1
    return out
