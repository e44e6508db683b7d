"""GroupNorm(+pre-bias)(+SiLU): the CUDA kernel and its plain version.

Replaces ``dvdx_tpu/ops/groupnorm.py:group_norm_act`` (``_gn_pallas`` /
``_gn_kernel``). Kernel: ``csrc/groupnorm.cu`` -- a deterministic two-phase
reduction (per-chunk channel sums in a fixed order, then per-group totals in
chunk order) followed by a fused normalise / affine / SiLU pass. Bounded by
bytes.

The JAX package sends only deep-level rows (<= 512 KB) to its TPU kernel
(``groupnorm.py:165-176``, a TPU measurement gate) and runs flax GroupNorm
elsewhere; the port sends every GroupNorm of the UNet and the VAE through
this one function. Both compute f32 one-pass moments; the pre-bias is added
in f32 here, where the JAX ResnetBlock2D fallback adds it in the activation
dtype first (tests state how far that moves the result).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

LAUNCHES = 0  # kernel launches since the last reset (a plain count)
MAX_CHANNELS = 2560
_ROWS = 64  # rows per reduction chunk (csrc/groupnorm.cu ROWS)


def group_norm_act_plain(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, *, groups: int, eps: float,
                         act: str = "none",
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm over the non-leading axes of x (N, ..., C) in f32 with
    one-pass moments (variance clamped at 0), optional (N, C) pre-bias,
    optional SiLU; result in x's dtype."""
    shape = x.shape
    n, c = shape[0], shape[-1]
    xf = x.reshape(n, -1, c).float()
    if bias is not None:
        xf = xf + bias.float()[:, None, :]
    xg = xf.reshape(n, xf.shape[1], groups, c // groups)
    mean = xg.mean(dim=(1, 3))
    var = torch.clamp((xg * xg).mean(dim=(1, 3)) - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    cpg = c // groups
    scale = rstd.repeat_interleave(cpg, dim=1) * gamma.float()
    shift = beta.float() - mean.repeat_interleave(cpg, dim=1) * scale
    y = xf * scale[:, None, :] + shift[:, None, :]
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype).reshape(shape)


def group_norm_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   *, groups: int, eps: float, act: str = "none",
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused GroupNorm over the non-leading axes of x (N, ..., C), with an
    optional per-sample channel bias (N, C) added before normalisation and
    an optional SiLU. CPU tensors take the plain version; CUDA tensors
    launch the kernel (bf16, C <= 2560) or raise."""
    if act not in ("none", "silu"):
        raise ValueError(f"group_norm_act: unknown act {act!r}")
    if x.device.type == "cpu":
        return group_norm_act_plain(x, gamma, beta, groups=groups, eps=eps,
                                    act=act, bias=bias)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_act: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError("group_norm_act: the kernel takes bfloat16")
    shape = x.shape
    n, c = shape[0], shape[-1]
    if c % groups or c > MAX_CHANNELS or gamma.numel() != c or beta.numel() != c:
        raise ValueError(f"group_norm_act: C={c} with {groups} groups unsupported")
    if any(t is not None and t.device != x.device for t in (gamma, beta, bias)):
        raise ValueError("group_norm_act: x, the affine and the bias must share one device")
    x3 = x.reshape(n, -1, c).contiguous()
    length = x3.shape[1]
    g32 = gamma.to(torch.float32).contiguous()
    b32 = beta.to(torch.float32).contiguous()
    bias_t = None if bias is None else bias.to(x.dtype).reshape(n, c).contiguous()
    y = torch.empty_like(x3)
    nchunks = -(-length // _ROWS)
    part = torch.empty((n, nchunks, groups, 2), dtype=torch.float32, device=x.device)
    stats = torch.empty((n, groups, 2), dtype=torch.float32, device=x.device)
    lib = _build.library("groupnorm")
    fn = lib.dvdx_group_norm
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    rc = fn(_build.ptr(x3),
            ctypes.c_void_p(None if bias_t is None else bias_t.data_ptr()),
            _build.ptr(g32), _build.ptr(b32), _build.ptr(y), _build.ptr(part),
            _build.ptr(stats), n, length, c, groups, float(eps),
            int(act == "silu"), _build.stream(x.device))
    _build.check(lib, rc, "group_norm_act")
    global LAUNCHES
    LAUNCHES += 1
    return y.reshape(shape)
