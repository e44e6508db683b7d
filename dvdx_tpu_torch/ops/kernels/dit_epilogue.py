"""Epilogues of the published CogVideoX block's dense layers: the CUDA kernels
and their plain versions.

Replaces no TPU kernel; serves ``models/cogvideox.py``. Kernel:
``csrc/dit_epilogue.cu``, one bytes-bound pass each over a layer's product
y (..., C) (the product without its bias, as ``F.linear`` gives it):

* ``bias_gelu_``: y = gelu_tanh(y + b), in place (the feed-forward's first
  layer);
* ``gated_residual_``: x = x + g * (y + b) into the residual stream x
  (B, S, C), g the block's gate (B, 1, C) at the video rows and its text
  gate at the first ``n_text`` rows (the attention's ``to_out`` and the
  feed-forward's second layer).

Each computes in float32 and rounds once to y's (x's) dtype, the plain
versions too. A wrapper launches the kernel for tensors on the card and
runs the plain version for tensors on the CPU; card tensors its gate
(``_bias_args`` / ``_gated_args``: bf16, contiguous, C % 8 == 0, 16-byte
aligned) refuses raise, so that no plain pass runs unseen on the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build

LAUNCHES = 0        # bias_gelu kernel launches since the last reset
GATED_LAUNCHES = 0  # gated_residual kernel launches since the last reset

_launchers = None  # (library, bias_gelu, gated_residual, the current stream's pointer)


def bias_gelu_plain(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y <- gelu_tanh(y + b) in float32, rounded once; y returned."""
    return y.copy_(F.gelu(y.float() + b.float(), approximate="tanh"))


def gated_residual_plain(x: torch.Tensor, y: torch.Tensor, b: torch.Tensor,
                         gate: torch.Tensor, enc_gate: torch.Tensor, n_text: int) -> torch.Tensor:
    """x <- x + g * (y + b) in float32, rounded once, g = enc_gate on the
    first ``n_text`` rows and gate on the rest; x returned."""
    v = y.float() + b.float()
    for rows, g in ((slice(n_text, None), gate), (slice(0, n_text), enc_gate)):
        xs = x[:, rows]
        xs.copy_(torch.addcmul(xs.float(), v[:, rows], g.float()))
    return x


def _layout(t: torch.Tensor) -> str:
    return f"{tuple(t.shape)} {t.dtype} strides {t.stride()} on {t.device}"


def _plain_ok(*tensors) -> bool:
    return all(t.dtype is torch.bfloat16 and t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors)


def _bias_args(y: torch.Tensor, b: torch.Tensor):
    """The bias_gelu kernel's gate: y bf16 contiguous (..., C), C % 8 == 0;
    b (C,) bf16 contiguous; both 16-byte aligned on one card; no gradient."""
    c = y.shape[-1]
    if c % 8 or b.numel() != c or not _plain_ok(y, b) or b.get_device() != y.get_device():
        return None
    if torch.is_grad_enabled() and (y.requires_grad or b.requires_grad):
        return None
    return y.numel() // c, c


def _gated_args(x, y, b, gate, enc_gate):
    """The gated_residual kernel's gate: x and y bf16 contiguous (B, S, C) of
    one shape, C % 8 == 0; b (C,) bf16 contiguous; gate and enc_gate bf16
    (B, 1, C) views with unit-stride channels and one batch stride, a
    multiple of 8; all 16-byte aligned on one card; no gradient."""
    if x.dim() != 3 or x.shape != y.shape:
        return None
    bsz, s, c = x.shape
    if c % 8 or b.numel() != c or not _plain_ok(x, y, b):
        return None
    for g in (gate, enc_gate):
        if (g.dtype is not torch.bfloat16 or g.shape != (bsz, 1, c) or g.stride(-1) != 1
                or g.data_ptr() % 16 or g.get_device() != x.get_device()):
            return None
    stride = gate.stride(0)
    if enc_gate.stride(0) != stride or (bsz > 1 and stride % 8):
        return None
    if any(t.get_device() != x.get_device() for t in (y, b)):
        return None
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, y, b, gate, enc_gate)):
        return None
    return bsz, s, c, stride if bsz > 1 else 0


def _load():
    global _launchers
    lib = _build.library("dit_epilogue")
    gelu, gated = lib.dvdx_bias_gelu, lib.dvdx_gated_residual
    gelu.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    gated.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                      + [ctypes.c_void_p])
    gelu.restype = gated.restype = ctypes.c_int
    _launchers = (lib, gelu, gated, torch._C._cuda_getCurrentRawStream)
    return _launchers


def bias_gelu_(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y <- gelu_tanh(y + b), in place, returned: one kernel launch on the
    card (a ValueError where the gate refuses the tensors), the plain
    version on the CPU."""
    if not y.is_cuda:
        return bias_gelu_plain(y, b)
    args = _bias_args(y, b)
    if args is None:
        raise ValueError(f"bias_gelu_: the kernel does not take y {_layout(y)}, b {_layout(b)}")
    lib, fn, _, raw = _launchers or _load()
    rc = fn(y.data_ptr(), b.data_ptr(), args[0], args[1], raw(y.get_device()))
    if rc:
        _build.check(lib, rc, "bias_gelu")
    global LAUNCHES
    LAUNCHES += 1
    return y


def gated_residual_(x: torch.Tensor, y: torch.Tensor, b: torch.Tensor, gate: torch.Tensor,
                    enc_gate: torch.Tensor, n_text: int) -> torch.Tensor:
    """x <- x + g * (y + b), g = gate at the video rows and enc_gate at the
    first ``n_text`` rows, in place, returned: one kernel launch on the card
    (a ValueError where the gate refuses the tensors), the plain version on
    the CPU."""
    if not x.is_cuda:
        return gated_residual_plain(x, y, b, gate, enc_gate, n_text)
    args = _gated_args(x, y, b, gate, enc_gate)
    if args is None:
        raise ValueError("gated_residual_: the kernel does not take "
                         + ", ".join(f"{k} {_layout(t)}" for k, t in (
                             ("x", x), ("y", y), ("b", b), ("gate", gate),
                             ("enc_gate", enc_gate))))
    bsz, s, c, stride = args
    lib, _, fn, raw = _launchers or _load()
    rc = fn(x.data_ptr(), y.data_ptr(), b.data_ptr(), gate.data_ptr(), enc_gate.data_ptr(),
            stride, bsz, s, n_text, c, raw(x.get_device()))
    if rc:
        _build.check(lib, rc, "gated_residual")
    global GATED_LAUNCHES
    GATED_LAUNCHES += 1
    return x
