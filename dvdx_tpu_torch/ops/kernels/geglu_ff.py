"""GEGLU feed-forward: the CUDA kernels and their plain versions.

Replaces ``dvdx_tpu/ops/pallas/geglu_ff.py:geglu_ff`` (``_geglu_kernel``).
Kernels: ``csrc/geglu_ff.cu`` over ``csrc/geglu_gemm.cuh`` -- two wgmma
products with fused epilogues, fed by TMA rings in shared memory:
``geglu_in`` writes the inner tensor h = bf16(value) * gelu(bf16(gate))
rounded to bf16, ``geglu_out`` reads it back and adds the output bias.

The inner tensor goes through device memory. The TPU kernel keeps it on
chip, which on a v5e (819 GB/s) was worth it; on the H100 (3.35 TB/s) its
2*T*I*2 bytes cost a fraction of the products' bound (118 MB, 35 us, against
229 us at T = 5760, C = 1280), while keeping it on chip forces the whole
(tile x C) f32 output accumulator into registers and shrinks the token tile
as C grows. The wrapper allocates h with ``torch.empty``.

Value and gate are rounded to the activation dtype where the JAX kernel
rounds them; GELU is the exact-erf form with CUDA's ``erff`` (the plain
version uses ``torch.erf``; the JAX kernel's A&S 7.1.26 ``_erf`` is a TPU
workaround for a missing primitive). Bounded by tensor-core operations at
the UNet's token counts.

The wgmma pair takes bf16 at C % 64 == 0 and I % 128 == 0. ``geglu_ff``
launches every other input the Pallas kernel takes with the same rounding
points: float32 through the port's one float32 GEGLU (``dvdx_geglu_f32``,
``csrc/f32_rows.cuh``'s f32_gemm, which the float32 fused tail and block
run too: three TF32 passes on the tensor cores, x = big + small, within
float32's rounding, any width and alignment; bound 3 * 6 T C I flops at 495
TFLOP/s), bf16 at any other width (such as zeroscope-tiny's C = 32) through
the bf16 CUDA-core pair of the same source (``dvdx_geglu_simt``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _build

LAUNCHES = 0        # geglu_ff calls that launched the wgmma pair since the last reset
SIMT_LAUNCHES = 0   # geglu_ff calls that launched another pair: float32 (three TF32
                    # passes), or bf16 at another width (the CUDA cores)
STAGE_LAUNCHES = 0  # geglu_in / geglu_out calls on their own (phase-3 rows)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def geglu_in_plain(x: torch.Tensor, w_in: torch.Tensor,
                   b_in: torch.Tensor) -> torch.Tensor:
    """h = (x Wv + bv) * gelu(x Wg + bg) with f32 products of x.dtype-rounded
    operands, value and gate rounded to x.dtype, h rounded to x.dtype.
    w_in: nn.Linear's (2I, C), value rows first."""
    dt = x.dtype
    inner = w_in.shape[0] // 2
    hg = x.float() @ w_in.to(dt).float().t() + b_in.to(dt).float()
    val = hg[..., :inner].to(dt).float()
    gate = hg[..., inner:].to(dt).float()
    h = val * (0.5 * gate * (1.0 + torch.erf(gate * (1.0 / math.sqrt(2.0)))))
    return h.to(dt)


def geglu_out_plain(h: torch.Tensor, w_out: torch.Tensor, b_out: torch.Tensor,
                    resid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h Wo^T + bo in f32, rounded once to h.dtype; with resid, resid plus
    that rounded sum. w_out: nn.Linear's (C, I)."""
    dt = h.dtype
    y = (h.float() @ w_out.to(dt).float().t() + b_out.to(dt).float()).to(dt)
    return y if resid is None else resid + y


def geglu_ff_plain(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
                   w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    """((x Wv + bv) * gelu(x Wg + bg)) Wo + bo with the kernels' rounding
    points: the two stages composed."""
    return geglu_out_plain(geglu_in_plain(x, w_in, b_in), w_out, b_out)


def _fn(name: str, n_ptr: int):
    lib = _build.library("geglu_ff")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def _launch_in(x2d, w_in, b_in) -> torch.Tensor:
    t, c = x2d.shape
    inner = w_in.shape[0] // 2
    h = torch.empty((t, inner), dtype=x2d.dtype, device=x2d.device)
    lib, fn = _fn("dvdx_geglu_in", 4)
    rc = fn(_build.ptr(x2d), _build.ptr(w_in), _build.ptr(b_in), _build.ptr(h),
            t, c, inner, _build.stream(x2d.device))
    _build.check(lib, rc, "geglu_in")
    return h


def _launch_out(h, w_out, b_out, resid) -> torch.Tensor:
    t, inner = h.shape
    c = w_out.shape[0]
    out = torch.empty((t, c), dtype=h.dtype, device=h.device)
    lib, fn = _fn("dvdx_geglu_out", 5)
    rc = fn(_build.ptr(h), _build.ptr(w_out), _build.ptr(b_out),
            None if resid is None else _build.ptr(resid), _build.ptr(out),
            t, c, inner, _build.stream(h.device))
    _build.check(lib, rc, "geglu_out")
    return out


def wgmma_takes(dtype: torch.dtype, c: int, inner: int) -> bool:
    """True where ``geglu_ff`` launches the wgmma pair (else the float32
    pair or the bf16 CUDA-core pair)."""
    return dtype == torch.bfloat16 and c % 64 == 0 and inner % 128 == 0


def _launch_simt(x2d, w_in, b_in, w_out, b_out) -> torch.Tensor:
    t, c = x2d.shape
    inner = w_in.shape[0] // 2
    h = torch.empty((t, inner), dtype=x2d.dtype, device=x2d.device)
    out = torch.empty((t, c), dtype=x2d.dtype, device=x2d.device)
    lib = _build.library("geglu_ff")
    fn = lib.dvdx_geglu_f32 if x2d.dtype == torch.float32 else lib.dvdx_geglu_simt
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    rc = fn(*(_build.ptr(a) for a in (x2d, w_in, b_in, h, w_out, b_out, out)), t, c, inner,
            _build.stream(x2d.device))
    _build.check(lib, rc, "geglu_ff (float32 or CUDA-core pair)")
    return out


def _operands(name, x, *params, dtypes=(torch.bfloat16,)):
    """x as contiguous (T, C) and the parameters cast to x's dtype and made
    contiguous; raises on what the kernels do not take."""
    if x.dtype not in dtypes:
        raise ValueError(f"{name}: the kernel takes {', '.join(map(str, dtypes))}, "
                         f"not {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if any(p.device != x.device for p in params if p is not None):
        raise ValueError(f"{name}: x and the weights must share one device")
    ops = [x.reshape(-1, x.shape[-1]).contiguous()]
    ops += [None if p is None else p.to(x.dtype).contiguous() for p in params]
    if any(p is not None and p.data_ptr() % 16 for p in ops):
        raise ValueError(f"{name}: operands must be 16-byte aligned")
    return ops


def _check_in(name, c, w_in, b_in):
    inner = w_in.shape[0] // 2
    if c % 64 or inner % 128 or w_in.shape != (2 * inner, c) or b_in.shape != (2 * inner,):
        raise ValueError(f"{name}: unsupported width C={c}, inner={inner}")


def _check_out(name, inner, w_out, b_out):
    c = w_out.shape[0]
    if c % 64 or inner % 64 or w_out.shape != (c, inner) or b_out.shape != (c,):
        raise ValueError(f"{name}: unsupported width C={c}, inner={inner}")


def geglu_in(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor) -> torch.Tensor:
    """The first stage alone over x (..., C) -> (..., I). CPU tensors take the
    plain version; CUDA tensors launch the kernel (bf16, C % 64 == 0, I % 128
    == 0) or raise."""
    if x.device.type == "cpu":
        return geglu_in_plain(x, w_in, b_in)
    _check_in("geglu_in", x.shape[-1], w_in, b_in)
    x2d, wi, bi = _operands("geglu_in", x, w_in, b_in)
    h = _launch_in(x2d, wi, bi)
    global STAGE_LAUNCHES
    STAGE_LAUNCHES += 1
    return h.reshape(*x.shape[:-1], h.shape[-1])


def geglu_out(h: torch.Tensor, w_out: torch.Tensor, b_out: torch.Tensor,
              resid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The second stage alone over h (..., I) -> (..., C), plus resid (..., C)
    when given. CPU tensors take the plain version; CUDA tensors launch the
    kernel (bf16, C % 64 == 0, I % 64 == 0) or raise."""
    if h.device.type == "cpu":
        return geglu_out_plain(h, w_out, b_out, resid)
    _check_out("geglu_out", h.shape[-1], w_out, b_out)
    if resid is not None and resid.shape != (*h.shape[:-1], w_out.shape[0]):
        raise ValueError("geglu_out: resid must have the output's shape")
    h2d, wo, bo = _operands("geglu_out", h, w_out, b_out)
    r2d = None if resid is None else _operands("geglu_out", resid)[0]
    out = _launch_out(h2d, wo, bo, r2d)
    global STAGE_LAUNCHES
    STAGE_LAUNCHES += 1
    return out.reshape(*h.shape[:-1], out.shape[-1])


def geglu_ff(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
             w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    """GEGLU MLP over the last axis of x (..., C). CPU tensors take the plain
    version; CUDA tensors launch the wgmma pair (bf16, C % 64 == 0, I % 128
    == 0) or else the float32 pair (three TF32 passes on the tensor cores) or
    the bf16 CUDA-core pair at any width, or raise.
    Weights are cast to x's dtype, as nn.Dense(dtype=...) does."""
    if x.device.type == "cpu":
        return geglu_ff_plain(x, w_in, b_in, w_out, b_out)
    c = x.shape[-1]
    inner = w_in.shape[0] // 2
    if w_in.shape != (2 * inner, c) or b_in.shape != (2 * inner,) \
            or w_out.shape != (c, inner) or b_out.shape != (c,):
        raise ValueError(f"geglu_ff: weights {tuple(w_in.shape)} / {tuple(w_out.shape)} "
                         f"do not map C={c} through an inner width and back")
    xt, wi, bi, wo, bo = _operands("geglu_ff", x, w_in, b_in, w_out, b_out,
                                   dtypes=KERNEL_DTYPES)
    global LAUNCHES, SIMT_LAUNCHES
    if wgmma_takes(x.dtype, c, inner):
        out = _launch_out(_launch_in(xt, wi, bi), wo, bo, None)
        LAUNCHES += 1
    else:
        out = _launch_simt(xt, wi, bi, wo, bo)
        SIMT_LAUNCHES += 1
    return out.reshape(x.shape)
