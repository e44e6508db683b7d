"""GroupNorm(+pre-bias)(+SiLU): the CUDA kernel and its plain version.

Replaces ``dvdx_tpu/ops/groupnorm.py:group_norm_act`` (``_gn_pallas`` /
``_gn_kernel``). Kernel: ``csrc/groupnorm.cu`` -- one cooperative launch
of co-resident blocks in three phases split by grid-wide barriers: per-chunk
group partial sums, per-group statistics by a fixed tree over the chunks,
then the normalise / affine / SiLU pass over the chunks in reverse order (a
UNet row read last in phase 1 is still in L2). Every sum has a fixed order,
set by ``plan`` from the shape alone. Bounded by bytes.

The JAX package sends only deep-level rows (<= 512 KB) to its TPU kernel
(``groupnorm.py:165-176``, a TPU measurement gate) and runs flax GroupNorm
elsewhere; the port sends every GroupNorm of the UNet and the VAE through
this one function. The kernel is one template over bf16 and float32 (the
float32 test models), as the Pallas kernel takes either. Both compute f32
one-pass moments (the plain version sums them in float64 first); the pre-bias is added
in f32 here, where the JAX ResnetBlock2D fallback adds it in the activation
dtype first (tests state how far that moves the result).

A GroupNorm whose frames are sharded over ranks (``group_norm_act_sharded``)
runs the kernel's first and last phases as two entries of the same source,
with an all-reduce between them: ``group_norm_moments`` (moments-out, float64
sums per (sample, group)) and ``group_norm_apply`` (moments-in, the
normalisation from given float32 moments). Each has its own launch counter.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

LAUNCHES = 0      # bf16 kernel launches since the last reset (a plain count)
F32_LAUNCHES = 0  # float32 kernel launches since the last reset
MOMENTS_OUT_LAUNCHES = 0  # group_norm_moments calls on the card (either dtype)
MOMENTS_IN_LAUNCHES = 0   # group_norm_apply calls on the card (either dtype)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
MAX_CHANNELS = 2560
CHUNK_ELEMS = 16384        # elements of one work item (32 KB of bf16) ...
LARGE_CHUNK_ELEMS = 32768  # ... and of one in a call of LARGE_CALL elements or more,
LARGE_CALL = 1 << 24       # where fewer, longer items read faster (utils/kernel_probe)


class GroupNormPlan(NamedTuple):
    chunk_rows: int  # rows of one work item of phases 1 and 3
    nchunks: int     # chunks per sample; the last may be short
    items: int       # (sample, chunk) work items


def plan(n: int, length: int, c: int, chunk_elems: Optional[int] = None) -> GroupNormPlan:
    """The kernel's chunking of (N, L, C): chunks of about ``chunk_elems``
    elements (whole rows; by default CHUNK_ELEMS, or LARGE_CHUNK_ELEMS from
    LARGE_CALL elements on), covering every row of every sample exactly
    once. A function of the shape only, so the kernel's sums run in one
    order."""
    if chunk_elems is None:
        chunk_elems = LARGE_CHUNK_ELEMS if n * length * c >= LARGE_CALL else CHUNK_ELEMS
    chunk_rows = max(1, min(length, chunk_elems // c))
    nchunks = -(-length // chunk_rows)
    return GroupNormPlan(chunk_rows, nchunks, n * nchunks)


def group_norm_act_plain(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, *, groups: int, eps: float,
                         act: str = "none",
                         bias: Optional[torch.Tensor] = None,
                         moments: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                         ) -> torch.Tensor:
    """GroupNorm over the non-leading axes of x (N, ..., C) in f32 with
    one-pass moments (variance clamped at 0), optional (N, C) pre-bias,
    optional SiLU; result in x's dtype. The moments' sums run in float64
    and round once to float32, so they do not depend on the order of the
    sum (``_moment_sums``); ``moments`` (mean, E[x^2]), each (N, groups)
    float32, replaces x's own (``group_norm_act_sharded``)."""
    shape = x.shape
    n, c = shape[0], shape[-1]
    xf = x.reshape(n, -1, c).float()
    if bias is not None:
        xf = xf + bias.float()[:, None, :]
    if moments is None:
        sums, count = _moment_sums(xf, groups)
        mean, sq = (sums / count).float()
    else:
        mean, sq = moments
    var = torch.clamp(sq - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    cpg = c // groups
    scale = rstd.repeat_interleave(cpg, dim=1) * gamma.float()
    shift = beta.float() - mean.repeat_interleave(cpg, dim=1) * scale
    y = xf * scale[:, None, :] + shift[:, None, :]
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype).reshape(shape)


def _moment_sums(xf: torch.Tensor, groups: int):
    """(the float64 sums of x and x^2 per (sample, group), stacked (2, N,
    G); the element count per group). A float32 square is exact in float64,
    and the float64 sum of a row's float32 values rounds to the same float32
    mean in any order (its error is ~2^-29 of a float32 ulp), so a sum split
    across ranks gives the one-device moments."""
    n, c = xf.shape[0], xf.shape[-1]
    xg = xf.reshape(n, -1, groups, c // groups).double()
    return (torch.stack([xg.sum(dim=(1, 3)), (xg * xg).sum(dim=(1, 3))]),
            float(xg.shape[1] * xg.shape[3]))


def _checked_rows(x: torch.Tensor, groups: int, what: str) -> torch.Tensor:
    """x (N, ..., C) on the card as a contiguous (N, L, C) view the entries
    take (bf16 or float32, C % 8 == 0, C <= 2560, 16-byte aligned), or raise."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{what}: the kernel takes bfloat16 or float32, not {x.dtype}")
    c = x.shape[-1]
    if c % groups or c % 8 or c > MAX_CHANNELS:
        raise ValueError(f"{what}: C={c} with {groups} groups unsupported")
    x3 = x.reshape(x.shape[0], -1, c).contiguous()
    if x3.data_ptr() % 16:
        raise ValueError(f"{what}: x must be 16-byte aligned")
    return x3


def group_norm_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   *, groups: int, eps: float, act: str = "none",
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused GroupNorm over the non-leading axes of x (N, ..., C), with an
    optional per-sample channel bias (N, C) added before normalisation and
    an optional SiLU. CPU tensors take the plain version; CUDA tensors
    launch the kernel (bf16 or float32, C % 8 == 0, C <= 2560) or raise."""
    if act not in ("none", "silu"):
        raise ValueError(f"group_norm_act: unknown act {act!r}")
    if x.device.type == "cpu":
        return group_norm_act_plain(x, gamma, beta, groups=groups, eps=eps,
                                    act=act, bias=bias)
    x3 = _checked_rows(x, groups, "group_norm_act")
    shape = x.shape
    n, length, c = x3.shape
    if gamma.numel() != c or beta.numel() != c:
        raise ValueError(f"group_norm_act: C={c} with {groups} groups unsupported")
    if any(t is not None and t.device != x.device for t in (gamma, beta, bias)):
        raise ValueError("group_norm_act: x, the affine and the bias must share one device")
    g32 = gamma.to(torch.float32).contiguous()
    b32 = beta.to(torch.float32).contiguous()
    bias_t = None if bias is None else bias.to(x.dtype).reshape(n, c).contiguous()
    if bias_t is not None and bias_t.data_ptr() % 16:
        raise ValueError("group_norm_act: the bias must be 16-byte aligned")
    y = torch.empty_like(x3)
    pl = plan(n, length, c)
    part = torch.empty((n, pl.nchunks, groups, 2), dtype=torch.float32, device=x.device)
    stats = torch.empty((n, groups, 2), dtype=torch.float32, device=x.device)
    lib = _build.library("groupnorm")
    fn = lib.dvdx_group_norm
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    rc = fn(_build.ptr(x3),
            ctypes.c_void_p(None if bias_t is None else bias_t.data_ptr()),
            _build.ptr(g32), _build.ptr(b32), _build.ptr(y), _build.ptr(part),
            _build.ptr(stats), n, length, c, groups, pl.chunk_rows, pl.nchunks, float(eps),
            int(act == "silu"), int(x.dtype == torch.float32), _build.stream(x.device))
    _build.check(lib, rc, "group_norm_act")
    global LAUNCHES, F32_LAUNCHES
    if x.dtype == torch.float32:
        F32_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return y.reshape(shape)


def group_norm_moments(x: torch.Tensor, groups: int) -> Tuple[torch.Tensor, float]:
    """Moments-out: (the float64 sums of x and x^2 per (sample, group) over
    the non-leading axes of x (N, ..., C), stacked (2, N, G); the element
    count per group). CPU tensors take ``_moment_sums``; CUDA tensors launch
    the kernel's ``dvdx_group_norm_moments`` or raise."""
    if x.device.type == "cpu":
        return _moment_sums(x.reshape(x.shape[0], -1, x.shape[-1]).float(), groups)
    x3 = _checked_rows(x, groups, "group_norm_moments")
    n, length, c = x3.shape
    pl = plan(n, length, c)
    part = torch.empty((n, pl.nchunks, groups, 2), dtype=torch.float64, device=x.device)
    sums = torch.empty((2, n, groups), dtype=torch.float64, device=x.device)
    lib = _build.library("groupnorm")
    fn = lib.dvdx_group_norm_moments
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    rc = fn(_build.ptr(x3), _build.ptr(part), _build.ptr(sums), n, length, c, groups,
            pl.chunk_rows, pl.nchunks, int(x.dtype == torch.float32), _build.stream(x.device))
    _build.check(lib, rc, "group_norm_moments")
    global MOMENTS_OUT_LAUNCHES
    MOMENTS_OUT_LAUNCHES += 1
    return sums, float(length * (c // groups))


def group_norm_apply(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     moments: Tuple[torch.Tensor, torch.Tensor], *, groups: int, eps: float,
                     act: str = "none") -> torch.Tensor:
    """Moments-in: GroupNorm of x (N, ..., C) with the given float32 moments
    (mean, E[x^2]), each (N, groups), as ``group_norm_act_plain(...,
    moments=)`` applies them. CPU tensors take that plain version; CUDA
    tensors launch the kernel's ``dvdx_group_norm_apply`` or raise."""
    if act not in ("none", "silu"):
        raise ValueError(f"group_norm_apply: unknown act {act!r}")
    if x.device.type == "cpu":
        return group_norm_act_plain(x, gamma, beta, groups=groups, eps=eps, act=act,
                                    moments=moments)
    x3 = _checked_rows(x, groups, "group_norm_apply")
    n, length, c = x3.shape
    m = torch.stack([t.to(x.device, torch.float32).reshape(n, groups) for t in moments])
    if gamma.numel() != c or beta.numel() != c or any(
            t.device != x.device for t in (gamma, beta)):
        raise ValueError("group_norm_apply: gamma and beta must be (C,) on x's device")
    g32 = gamma.to(torch.float32).contiguous()
    b32 = beta.to(torch.float32).contiguous()
    y = torch.empty_like(x3)
    pl = plan(n, length, c)
    lib = _build.library("groupnorm")
    fn = lib.dvdx_group_norm_apply
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    rc = fn(_build.ptr(x3), _build.ptr(m), _build.ptr(g32), _build.ptr(b32), _build.ptr(y),
            n, length, c, groups, pl.chunk_rows, pl.nchunks, float(eps), int(act == "silu"),
            int(x.dtype == torch.float32), _build.stream(x.device))
    _build.check(lib, rc, "group_norm_apply")
    global MOMENTS_IN_LAUNCHES
    MOMENTS_IN_LAUNCHES += 1
    return y.reshape(x.shape)


def group_norm_act_sharded(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                           *, groups: int, eps: float, act: str = "none",
                           group=None, group_size: int = 1) -> torch.Tensor:
    """GroupNorm of x (N, ..., C) whose statistics span the non-leading
    axes on every rank of ``group`` (frames sharded over the mesh's seq
    axis): each rank's float64 group sums of x and x^2 and its element
    count (moments-out) are all-reduced in one float64 message, and each
    rank normalises its frames with the global moments (moments-in), which
    are the one-device moments' float32 values (``_moment_sums``). With one
    rank this is ``group_norm_act`` (the fused kernel on the card). CUDA
    tensors launch the two entries of ``csrc/groupnorm.cu`` or raise."""
    if group is None or group_size <= 1:
        return group_norm_act(x, gamma, beta, groups=groups, eps=eps, act=act)
    import torch.distributed as dist

    sums, count = group_norm_moments(x, groups)
    msg = torch.cat([sums.reshape(-1), sums.new_tensor([count])])
    dist.all_reduce(msg, group=group)
    mean, sq = (msg[:-1].view(sums.shape) / msg[-1]).float()
    return group_norm_apply(x, gamma, beta, (mean, sq), groups=groups, eps=eps, act=act)
