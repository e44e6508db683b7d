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
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

LAUNCHES = 0      # bf16 kernel launches since the last reset (a plain count)
F32_LAUNCHES = 0  # float32 kernel launches since the last reset
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
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_act: unsupported device {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"group_norm_act: the kernel takes bfloat16 or float32, not {x.dtype}")
    shape = x.shape
    n, c = shape[0], shape[-1]
    if c % groups or c % 8 or c > MAX_CHANNELS or gamma.numel() != c or beta.numel() != c:
        raise ValueError(f"group_norm_act: C={c} with {groups} groups unsupported")
    if any(t is not None and t.device != x.device for t in (gamma, beta, bias)):
        raise ValueError("group_norm_act: x, the affine and the bias must share one device")
    x3 = x.reshape(n, -1, c).contiguous()
    length = x3.shape[1]
    g32 = gamma.to(torch.float32).contiguous()
    b32 = beta.to(torch.float32).contiguous()
    bias_t = None if bias is None else bias.to(x.dtype).reshape(n, c).contiguous()
    if any(t is not None and t.data_ptr() % 16 for t in (x3, bias_t)):
        raise ValueError("group_norm_act: x and the bias must be 16-byte aligned")
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


# ROADMAP item named where a frame-sharded GroupNorm meets a CUDA tensor
SHARDED_ROADMAP = "ROADMAP.md §1, M10 rest: a moments-in entry for csrc/groupnorm.cu"


def group_norm_act_sharded(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                           *, groups: int, eps: float, act: str = "none",
                           group=None, group_size: int = 1) -> torch.Tensor:
    """GroupNorm of x (N, ..., C) whose statistics span the non-leading
    axes on every rank of ``group`` (frames sharded over the mesh's seq
    axis): each rank's float64 group sums of x and x^2 and its element
    count are all-reduced, and the plain version normalises with the global
    moments (the one-device moments' float32 values: ``_moment_sums``). With one rank this is ``group_norm_act`` (the kernel on the
    card). A CUDA tensor over more than one rank raises: the kernel takes no
    moments yet, and its plain version does not stand in for it on the card."""
    if group is None or group_size <= 1:
        return group_norm_act(x, gamma, beta, groups=groups, eps=eps, act=act)
    if x.device.type != "cpu":
        raise NotImplementedError(
            f"group_norm_act_sharded: GroupNorm over frames sharded on {group_size} "
            f"ranks has no CUDA kernel yet ({SHARDED_ROADMAP})")
    import torch.distributed as dist

    sums, count = _moment_sums(x.reshape(x.shape[0], -1, x.shape[-1]).float(), groups)
    count = torch.tensor([count], dtype=torch.float64)
    dist.all_reduce(sums, group=group)
    dist.all_reduce(count, group=group)
    mean, sq = (sums / count).float()
    return group_norm_act_plain(x, gamma, beta, groups=groups, eps=eps, act=act,
                                moments=(mean, sq))
