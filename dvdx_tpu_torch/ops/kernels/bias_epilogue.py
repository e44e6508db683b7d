"""Bias (+ residual) epilogue of the convolutions and dense layers: the CUDA
kernel and its plain version.

Replaces no TPU kernel (XLA fuses a bias add into the product on the TPU).
Kernel: ``csrc/bias_epilogue.cu`` -- one bytes-bound pass over the product
y (rows, C) in place: y + b rounded to y's dtype, and, where the layer's
caller adds a residual next, r plus that rounded sum, rounded again. Each
sum is float32, as ATen's add takes it, so the result is bit for bit the
plain version's ``y + b`` and ``r + (y + b)``: ATen's broadcast add of the
bias has no vectorised path (the bias's stride over the rows is 0) and the
residual add reads the output back once more.

``bias_epilogue`` launches the kernel where y lies on the card and the gate
(``_launch_args``) takes the tensors, and otherwise (CPU tensors, other
dtypes or layouts) runs the plain version. The gate reads only the tensors:
no knob and no model name. Both write into y's own storage, so a caller
passes the product's fresh buffer; nothing is allocated.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

LAUNCHES = 0      # bf16 kernel launches since the last reset
F32_LAUNCHES = 0  # float32 kernel launches since the last reset
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_BF16, _F32 = KERNEL_DTYPES

_launcher = None  # (library, launcher with its argtypes set, the current stream's pointer)


def bias_epilogue_plain(y: torch.Tensor, bias: torch.Tensor,
                        residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y + bias, then residual + that, each rounded to y's dtype and written
    into y, which is returned: ATen's in-place adds, the same bits as ``y +
    bias`` and ``residual + (y + bias)`` (a sum of two numbers does not
    depend on their order). bias and the residual are of y's dtype."""
    y.add_(bias)
    return y if residual is None else y.add_(residual)


def _launch_args(y: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor]):
    """The kernel's gate: (rows, C, the data pointers of y, bias and
    residual, y's device index) of its launch over y, or None where it
    refuses the tensors. It takes y bf16 or float32, contiguous, 16-byte
    aligned, C = y.shape[-1] a multiple of 8; bias C values of y's dtype,
    contiguous and aligned; a residual of y's shape and dtype, contiguous and
    aligned; all on y's device; nothing that records a gradient
    (``bias_epilogue`` asks first whether that device is the card). Runs
    before every launch, so each tensor property is read once."""
    dt = y.dtype
    if (dt is not _BF16 and dt is not _F32) or bias.dtype is not dt:
        return None
    dev = y.get_device()
    if bias.get_device() != dev or (residual is not None and residual.get_device() != dev):
        return None
    c, n = y.shape[-1], y.numel()
    yp, bp = y.data_ptr(), bias.data_ptr()
    if (c % 8 or not n or bias.numel() != c or (yp | bp) % 16 or not y.is_contiguous()
            or not bias.is_contiguous()):
        return None
    rp = None
    if residual is not None:
        rp = residual.data_ptr()
        if (residual.dtype is not dt or rp % 16 or residual.shape != y.shape
                or not residual.is_contiguous()):
            return None
    if torch.is_grad_enabled() and (y.requires_grad or bias.requires_grad or (
            residual is not None and residual.requires_grad)):
        return None
    return n // c, c, yp, bp, rp, dev


def _load():
    global _launcher
    lib = _build.library("bias_epilogue")
    fn = lib.dvdx_bias_epilogue
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # torch's current stream of a device, as a raw pointer: what
    # torch.cuda.current_stream(dev).cuda_stream reads, without building the
    # Stream object on every launch
    _launcher = (lib, fn, torch._C._cuda_getCurrentRawStream)
    return _launcher


def bias_epilogue(y: torch.Tensor, bias: torch.Tensor,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y + bias, then residual + that where a residual is given, each rounded
    to y's dtype, written into y, which is returned: one kernel launch where y
    lies on the card and the gate (``_launch_args``) takes the tensors, the
    plain version otherwise. y is the product of a layer (..., C), bias (C,),
    the residual y's shape; both of y's dtype."""
    args = _launch_args(y, bias, residual) if y.is_cuda else None
    if args is None:
        return bias_epilogue_plain(y, bias, residual)
    rows, c, yp, bp, rp, dev = args
    lib, fn, raw = _launcher or _load()
    f32 = y.dtype is _F32
    rc = fn(yp, bp, rp, rows, c, f32, raw(dev))
    if rc:
        _build.check(lib, rc, "bias_epilogue")
    global LAUNCHES, F32_LAUNCHES
    if f32:
        F32_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return y
