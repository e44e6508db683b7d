"""Fused temporal transformer block: the CUDA kernel and its plain version.

Replaces ``dvdx_tpu/ops/pallas/temporal_block.py:fused_temporal_block``
(``_block_kernel``): the whole ``_TemporalBlock`` on frame-major
(B, F, N, C) -- LN1 and frame-axis self-attention, LN2 and the second
frame-axis self-attention (diffusers double_self_attention), LN3 and the
GEGLU feed-forward, each with its residual -- in the TPU kernel's rounding
order: x + (mm + b) after each attention, the unnormalised probabilities
exp(s - max) rounded to bf16 before P.V and the sum divided after, and the FF
output bias added in float32 before its one rounding.

Kernel: ``csrc/temporal_block.cu``, three launches with nothing between
them -- the chain (both attention sub-blocks and LN3) on 64-row tiles of
P positions x F frames (``plan``), its eight C x C products on wgmma with
the weights streamed by TMA, its F x F attention on the tensor cores; then
the GEGLU feed-forward as the two wgmma products of
``csrc/geglu_gemm.cuh``, the second with the residual epilogue; the inner
tensor goes through a (rows, I) scratch. Bounded by tensor-core
operations at the UNet's level 0; it takes C <= 384 (C % 64 == 0), head
widths that are multiples of 8, F <= 64 and I % 128 == 0.

Float32 inputs (a float32 model, as ``load_diffusers_checkpoint(dtype=
"float32")`` builds) launch ``csrc/temporal_block_f32.cu`` instead, at the
same shapes: the TPU kernel's math in float32, fifteen launches (per
attention sub-block LN on the CUDA cores, the q / k / v products, the
frame-axis attention through the port's one float32 attention,
``csrc/attention_f32.cuh``, on the body ``attention_f32.body`` picks: the
short-sequence tensor-core body at 16 or 24 frames, and the out-projection
with its residual; LN3 and the one float32 GEGLU pair), each product
``csrc/f32_rows.cuh``'s f32_gemm in three TF32 passes on the tensor cores
(x = big + small, within float32's rounding), the operands kept in float32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import torch

from .. import _build
from . import attention_f32
from .fused_math import dense, geglu_residual, layer_norm

LAUNCHES = 0  # calls that launched the kernel (its three launches) since the last reset
F32_LAUNCHES = 0  # calls that launched the float32 kernel (its fifteen launches)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
MAX_DIM = 384
MAX_FRAMES = 64
TILE_ROWS = 64      # rows of one chain tile (one wgmma m64)
MAX_STAGES = 6      # weight-ring stages (csrc/temporal_block.cu MAX_STAGES)
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on the H100
KEYS = ("ln1_s", "ln1_b", "q1", "k1", "v1", "o1_w", "o1_b",
        "ln2_s", "ln2_b", "q2", "k2", "v2", "o2_w", "o2_b",
        "ln3_s", "ln3_b", "ffi_w", "ffi_b", "ffo_w", "ffo_b")


class ChainPlan(NamedTuple):
    positions: int   # P: positions per 64-row tile
    tiles: int       # tiles per call (B * ceil(N / P))
    stages: int      # weight-ring stages (even: each feeds one warpgroup)
    smem_bytes: int  # dynamic shared memory of the chain kernel


def chain_smem_bytes(c: int, stages: int) -> int:
    """Alignment slack, the LN-output / k / v buffers (64 x C bf16 each),
    the ring of half-width 64-deep weight slices, mbarriers, the LayerNorm
    exchange."""
    return 1024 + 3 * TILE_ROWS * c * 2 + stages * (c // 2) * 128 + 2 * MAX_STAGES * 8 \
        + 2 * TILE_ROWS * 2 * 4


def plan(b: int, f: int, n: int, c: int) -> ChainPlan:
    """The chain kernel's tiling of x (B, F, N, C): the most positions P
    whose P * F rows fit a 64-row tile with the last position's frames,
    padded to 16 for the attention's tensor-core tiles, still inside it; and
    the most ring stages, even, that fit the shared memory."""
    if not 1 <= f <= MAX_FRAMES or c % 64 or not 64 <= c <= MAX_DIM:
        raise ValueError(f"temporal block chain: no plan for F={f}, C={c}")
    fpad = -(-f // 16) * 16
    p = TILE_ROWS // f
    while (p - 1) * f + fpad > TILE_ROWS:
        p -= 1
    stages = MAX_STAGES
    while chain_smem_bytes(c, stages) > SMEM_LIMIT:
        stages -= 2
    return ChainPlan(p, b * -(-n // p), stages, chain_smem_bytes(c, stages))


def check_shape(shape, heads: int, inner: int, q_shape) -> ChainPlan:
    """The kernel's plan for x of ``shape`` (B, F, N, C) with ``heads``
    heads, FF width ``inner`` and (C, C) projections, or ValueError where
    the kernel does not take the block."""
    b, f, n, c = shape
    if (c % 64 or not 64 <= c <= MAX_DIM or c % heads or (c // heads) % 8
            or not 1 <= f <= MAX_FRAMES
            or inner % 128 or tuple(q_shape) != (c, c) or min(b, n) < 1):
        raise ValueError(f"fused_temporal_block: unsupported shape {tuple(shape)} "
                         f"with {heads} heads")
    return plan(b, f, n, c)


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
    take the plain version; CUDA tensors launch the kernel of x's dtype (bf16
    or float32; every operand cast to it) or raise. Both dtypes take the
    same shapes."""
    if x.device.type == "cpu":
        return fused_temporal_block_plain(x, params, heads=heads, scale=scale,
                                          eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_temporal_block: unsupported device {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"fused_temporal_block: the kernel takes bfloat16 or float32, "
                         f"not {x.dtype}")
    b, f, n, c = x.shape
    inner = params["ffi_w"].shape[0] // 2
    pl = check_shape(tuple(x.shape), heads, inner, tuple(params["q1"].shape))
    ops = [x] + [params[k] for k in KEYS]
    if any(a.device != x.device for a in ops):
        raise ValueError("fused_temporal_block: every operand must be on x's device")
    ops = [a.to(x.dtype).contiguous() for a in ops]
    if any(a.data_ptr() % 16 for a in ops):
        raise ValueError("fused_temporal_block: operands must be 16-byte aligned")
    scale = (c // heads) ** -0.5 if scale is None else scale
    if x.dtype == torch.float32:
        return _launch_f32(ops, b, f, n, c, heads, inner, float(scale), float(eps))
    x_mid, h = torch.empty_like(ops[0]), torch.empty_like(ops[0])
    ff_inner = torch.empty((b * f * n, inner), dtype=x_mid.dtype, device=x_mid.device)
    out = torch.empty_like(ops[0])
    lib = _build.library("temporal_block")
    fn = lib.dvdx_temporal_block
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 25 + [ctypes.c_int] * 8
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    rc = fn(*(_build.ptr(a) for a in ops + [x_mid, h, ff_inner, out]), b, f, n, c, heads,
            inner, pl.positions, pl.stages, float(scale), float(eps),
            _build.stream(x.device))
    _build.check(lib, rc, "fused_temporal_block")
    global LAUNCHES
    LAUNCHES += 1
    return out


def f32_attention_body(f: int, n: int, c: int, heads: int) -> str:
    """The body of ``csrc/attention_f32.cuh`` that runs the float32 kernel's
    two frame-axis attentions: q, k, v (B, F, N, heads, D), contiguous,
    frame f of position n a query / key row, through the shape gate."""
    d = c // heads
    return attention_f32.body(f, f, d, [(f * n * c, c, n * c, d)])


def _launch_f32(ops, b: int, f: int, n: int, c: int, heads: int, inner: int, scale: float,
                eps: float) -> torch.Tensor:
    """The float32 kernel on contiguous float32 ``ops`` (x and the ``KEYS``
    parameters)."""
    x = ops[0]
    rows = b * f * n
    scratch = [torch.empty((rows, w), dtype=x.dtype, device=x.device)
               for w in (c,) * 7 + (inner,)]  # h, q, k, v, attention, x1, x2, inner
    out = torch.empty_like(x)
    lib = _build.library("temporal_block_f32")
    fn = lib.dvdx_temporal_block_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 30 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    chosen = f32_attention_body(f, n, c, heads)
    rc = fn(*(_build.ptr(a) for a in ops + scratch + [out]), b, f, n, c, heads, inner,
            scale, eps, attention_f32.BODY_CODE[chosen], _build.stream(x.device))
    _build.check(lib, rc, "fused_temporal_block (float32)")
    for _ in range(2):  # its two attention sub-blocks
        attention_f32.note_launch(chosen)
    global F32_LAUNCHES
    F32_LAUNCHES += 1
    return out
