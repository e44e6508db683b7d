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
-- the chain up to LN3, then the GEGLU feed-forward as the two wgmma
products of ``csrc/geglu_gemm.cuh``, the second with the residual epilogue;
the inner tensor goes through a (rows, I) scratch. The chain is one of two
kernels by width: at C <= 384 (C % 64 == 0) 64-row tiles (``plan``) with
the three C x C products on wgmma, the weights and each head's context K / V
streamed by TMA through one ring, and the cross-attention on the tensor
cores; at 384 < C <= 768 32-row tiles held in shared memory. Bounded by
tensor-core operations at the UNet's level 0; I % 128 == 0.

Float32 inputs (a float32 model, as ``load_diffusers_checkpoint(dtype=
"float32")`` builds) launch ``csrc/spatial_tail_f32.cu`` instead, at the
same shapes: the TPU kernel's math in float32 on the CUDA cores, eight
simple launches (the three C x C products, LN2 / LN3, the cross-attention
through the port's one float32 attention, ``csrc/attention_f32.cuh``, and
the one float32 GEGLU pair, each product a tiled f32 kernel of
``csrc/f32_rows.cuh`` with the residual in its epilogue), the operands kept
in float32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .. import _build
from .fused_math import dense, geglu_residual, layer_norm

LAUNCHES = 0  # calls that launched the kernel (its three launches) since the last reset
F32_LAUNCHES = 0  # calls that launched the float32 kernel (its eight launches)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
MAX_DIM = 768        # the wide chain's widths
CHAIN_MAX_DIM = 384  # the 64-row chain's
MAX_CONTEXT = 512
MAX_HEAD_DIM = 128
TILE_ROWS = 64       # rows of one chain tile (one wgmma m64)
KV_CHUNK = 128       # context tokens of one K / V fill at most (csrc KV_CHUNK)
MAX_STAGES = 6       # ring stages (csrc/chain_tile.cuh MAX_STAGES)
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on the H100
KEYS = ("o1_w", "o1_b", "ln2_s", "ln2_b", "q2_w", "o2_w", "o2_b",
        "ln3_s", "ln3_b", "ffi_w", "ffi_b", "ffo_w", "ffo_b")


class TailPlan(NamedTuple):
    tiles: int        # 64-row tiles of the rows
    tokens: int       # keys of one K / V fill: T padded to 16, at most KV_CHUNK
    chunks: int       # fills per (head, image) sweep; two sweeps where chunks > 1
    stages: int       # ring stages (even: each feeds one warpgroup)
    stage_bytes: int  # a ring stage: a weight slice or one head's K and V
    smem_bytes: int   # dynamic shared memory of the chain kernel


def kv_fill_bytes(d: int, tokens: int) -> int:
    """One head's K and V of ``tokens`` tokens in 64-lane boxes."""
    return 2 * -(-d // 64) * tokens * 128


def chain_smem_bytes(c: int, stages: int, stage_bytes: int) -> int:
    """Alignment slack, the A-operand and x buffers (64 x C bf16 each), the
    ring, its mbarriers and the x / o1 ones, the LayerNorm exchange."""
    return 1024 + 2 * TILE_ROWS * c * 2 + stages * stage_bytes + (2 * MAX_STAGES + 2) * 8 \
        + 2 * TILE_ROWS * 2 * 4


def plan(rows: int, s: int, c: int, hd: int, t: int, heads: int) -> TailPlan:
    """The 64-row chain's tiling of (rows, C) = (N * S, C) with ``heads``
    heads over hd = C lanes and T context tokens: 64-row tiles, the context
    in fills of T padded to 16 tokens (one pass) or of 128 tokens (two
    sweeps, T > 128), and the most ring stages, even, that fit the shared
    memory beside the two 64 x C buffers."""
    d = hd // heads if heads >= 1 else 0
    if (c % 64 or not 64 <= c <= CHAIN_MAX_DIM or hd != c or heads < 1 or hd % heads
            or d % 8 or not 8 <= d <= MAX_HEAD_DIM or not 1 <= t <= MAX_CONTEXT
            or s < 1 or rows < 1 or rows % s):
        raise ValueError(f"spatial tail chain: no plan for rows={rows}, S={s}, C={c}, "
                         f"HD={hd}, T={t}, heads={heads}")
    tokens = min(-(-t // 16) * 16, KV_CHUNK)
    stage = max(c // 2 * 128, kv_fill_bytes(d, tokens))
    stages = MAX_STAGES
    while stages > 2 and chain_smem_bytes(c, stages, stage) > SMEM_LIMIT:
        stages -= 2
    if chain_smem_bytes(c, stages, stage) > SMEM_LIMIT:
        raise ValueError(f"spatial tail chain: C={c}, d={d}, T={t} do not fit shared memory")
    return TailPlan(-(-rows // TILE_ROWS), tokens, -(-t // KV_CHUNK), stages, stage,
                    chain_smem_bytes(c, stages, stage))


def tile_images(tile: int, rows: int, s: int) -> Tuple[int, int]:
    """The first and last image whose rows a 64-row chain tile holds."""
    r0 = tile * TILE_ROWS
    return r0 // s, min(r0 + TILE_ROWS - 1, rows - 1) // s


def check_shape(n: int, s: int, c: int, hd1: int, hd: int, t: int, heads: int,
                inner: int) -> Optional[TailPlan]:
    """The 64-row chain's plan for x (N, S, C), o1 (N, S, HD1), a context of
    T tokens projected to HD lanes of ``heads`` heads and FF width
    ``inner``; None where the wide chain (384 < C <= 768) takes the block;
    ValueError where neither kernel does."""
    if inner % 128 or not 1 <= t <= MAX_CONTEXT or heads < 1 or hd % heads:
        raise ValueError(f"fused_spatial_tail: unsupported FF width {inner}, context {t} "
                         f"or heads {heads}")
    if c <= CHAIN_MAX_DIM:
        if hd1 != hd:
            raise ValueError(f"fused_spatial_tail: needs HD1 == HD == C (C={c}, HD1={hd1}, "
                             f"HD={hd})")
        return plan(n * s, s, c, hd, t, heads)
    d = hd // heads
    if (c % 64 or c > MAX_DIM or hd1 % 16 or hd1 > MAX_DIM or hd % 16 or hd > MAX_DIM
            or d % 16 or d > MAX_HEAD_DIM):
        raise ValueError(f"fused_spatial_tail: unsupported widths C={c}, HD1={hd1}, HD={hd}, "
                         f"heads={heads}")
    return None


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
    CPU tensors take the plain version; CUDA tensors launch the kernel of
    x's dtype (bf16 or float32; every operand cast to it) or raise. Both
    dtypes take the same shapes."""
    if x.device.type == "cpu":
        return fused_spatial_tail_plain(x, o1, ctx_k, ctx_v, params, heads=heads,
                                        scale=scale, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_spatial_tail: unsupported device {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"fused_spatial_tail: the kernel takes bfloat16 or float32, "
                         f"not {x.dtype}")
    n, s, c = x.shape
    hd1, hd, t = o1.shape[-1], params["q2_w"].shape[0], ctx_k.shape[1]
    inner = params["ffi_w"].shape[0] // 2
    if (o1.shape[:2] != (n, s) or ctx_k.shape != (n, t, hd) or ctx_v.shape != (n, t, hd)
            or tuple(params["q2_w"].shape) != (hd, c)):
        raise ValueError(f"fused_spatial_tail: unsupported shapes x {tuple(x.shape)}, "
                         f"o1 {tuple(o1.shape)}, ctx {tuple(ctx_k.shape)}")
    pl = check_shape(n, s, c, hd1, hd, t, heads, inner)
    ops = [x, o1, ctx_k, ctx_v] + [params[k] for k in KEYS]
    if any(a.device != x.device for a in ops):
        raise ValueError("fused_spatial_tail: every operand must be on x's device")
    ops = [a.to(x.dtype).contiguous() for a in ops]
    if any(a.data_ptr() % 16 for a in ops):
        raise ValueError("fused_spatial_tail: operands must be 16-byte aligned")
    scale = float(_scale(params, heads, scale))
    if x.dtype == torch.float32:
        return _launch_f32(ops, n, s, c, hd1, hd, t, heads, inner, scale, float(eps))
    x2, h = torch.empty_like(ops[0]), torch.empty_like(ops[0])
    ff_inner = torch.empty((n * s, inner), dtype=x2.dtype, device=x2.device)
    out = torch.empty_like(ops[0])
    lib = _build.library("spatial_tail")
    fn = lib.dvdx_spatial_tail
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 21 + [ctypes.c_int] * 9
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    rc = fn(*(_build.ptr(a) for a in ops + [x2, h, ff_inner, out]), n * s, s, c, hd1, hd,
            t, heads, inner, 0 if pl is None else pl.stages, scale, float(eps),
            _build.stream(x.device))
    _build.check(lib, rc, "fused_spatial_tail")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _launch_f32(ops, n: int, s: int, c: int, hd1: int, hd: int, t: int, heads: int,
                inner: int, scale: float, eps: float) -> torch.Tensor:
    """The float32 kernel on contiguous float32 ``ops`` (x, o1, ctx_k, ctx_v
    and the ``KEYS`` parameters)."""
    x = ops[0]
    rows = n * s
    scratch = [torch.empty((rows, w), dtype=x.dtype, device=x.device)
               for w in (c, c, hd, hd, c, inner)]  # x1, h, q, ao, x2, inner
    out = torch.empty_like(x)
    lib = _build.library("spatial_tail_f32")
    fn = lib.dvdx_spatial_tail_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 24 + [ctypes.c_int] * 8
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    rc = fn(*(_build.ptr(a) for a in ops + scratch + [out]), rows, s, c, hd1, hd, t, heads,
            inner, scale, eps, _build.stream(x.device))
    _build.check(lib, rc, "fused_spatial_tail (float32)")
    global F32_LAUNCHES
    F32_LAUNCHES += 1
    return out
