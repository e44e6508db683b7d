"""QK-LayerNorm and rotary embedding of a joint attention's queries and keys:
the CUDA kernel and its plain version.

Replaces no TPU kernel (the JAX package has no model with QK-norm); serves
the published CogVideoX block (``models/cogvideox.py``). Per (token, head)
row of q and of k: a LayerNorm over the head's lanes with float32
statistics and its own affine vectors, then, at the video positions (from
``n_text`` on), the rotary embedding of interleaved pairs, ``y cos + rot(y)
sin`` with ``rot(y)[2i] = -y[2i+1]``, ``rot(y)[2i+1] = y[2i]`` (diffusers'
``apply_rotary_emb`` with ``use_real_unbind_dim=-1``), all in float32 and
rounded once to the input's dtype. Kernel: ``csrc/qk_norm_rope.cu``, one
bytes-bound pass that reads q and k through their strides (views of the
fused projection) and writes them contiguous.

``qk_norm_rope`` launches the kernel for tensors on the card and runs the
plain version for tensors on the CPU; card tensors its gate
(``_launch_args``) refuses (float32, another head size, a stride or
pointer it cannot read) raise, so that no plain pass runs unseen on the
card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build

LAUNCHES = 0  # kernel launches since the last reset
HEAD_DIM = 64

_launcher = None  # (library, launcher with its argtypes set, the current stream's pointer)


def qk_norm_rope_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                       cos: torch.Tensor, sin: torch.Tensor, n_text: int) -> torch.Tensor:
    """x (B, S, H, D) -> LayerNorm over D with (weight, bias), the rows from
    ``n_text`` on rotated by the (S - n_text, 1, D) float32 tables; float32
    throughout, x's dtype out, contiguous."""
    y = F.layer_norm(x.float(), x.shape[-1:], weight.float(), bias.float(), eps)
    v = y[:, n_text:]
    rot = torch.stack((-v[..., 1::2], v[..., 0::2]), dim=-1).flatten(-2)
    y[:, n_text:] = v * cos + rot * sin
    return y.to(x.dtype)


def _aligned(t: torch.Tensor) -> bool:
    return t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1]) and t.data_ptr() % 16 == 0


def _layout(t: torch.Tensor) -> str:
    return f"{tuple(t.shape)} {t.dtype} strides {t.stride()} on {t.device}"


def _launch_args(q, k, norm_q, norm_k, cos, sin, n_text) -> Optional[int]:
    """The kernel's gate: q and k bf16 (B, S, H, 64) views on one card with
    unit-stride rows, strides a multiple of 8 and 16-byte aligned; the norms'
    vectors bf16, contiguous and aligned; the tables float32, contiguous,
    (S - n_text) x 64 values; nothing that records a gradient."""
    if q.dtype is not torch.bfloat16 or k.dtype is not torch.bfloat16:
        return None
    if q.shape != k.shape or q.shape[-1] != HEAD_DIM or not (_aligned(q) and _aligned(k)):
        return None
    vecs = (norm_q.weight, norm_q.bias, norm_k.weight, norm_k.bias)
    if any(v.dtype is not torch.bfloat16 or not v.is_contiguous() or v.numel() != HEAD_DIM
           or v.data_ptr() % 16 for v in vecs):
        return None
    dev = q.get_device()
    if any(t.get_device() != dev for t in (k, cos, sin) + vecs):
        return None
    if any(t.dtype is not torch.float32 or not t.is_contiguous() or t.data_ptr() % 16
           or t.numel() != (q.shape[1] - n_text) * HEAD_DIM for t in (cos, sin)):
        return None
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k) + vecs):
        return None
    return dev


def _load():
    global _launcher
    lib = _build.library("qk_norm_rope")
    fn = lib.dvdx_qk_norm_rope
    ll = ctypes.c_longlong
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ll] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _launcher = (lib, fn, torch._C._cuda_getCurrentRawStream)
    return _launcher


def qk_norm_rope(q: torch.Tensor, k: torch.Tensor, norm_q, norm_k, cos: torch.Tensor,
                 sin: torch.Tensor, n_text: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k (B, S, H, D) -> each normed by its ``nn.LayerNorm`` (``norm_q``,
    ``norm_k``: weight, bias, eps) and rotated at positions ``n_text`` on by
    the (S - n_text, 1, D) float32 tables; contiguous, q's dtype. One kernel
    launch for both on the card (a ValueError where the gate refuses the
    tensors), the plain version on the CPU."""
    if not q.is_cuda:
        return (qk_norm_rope_plain(q, norm_q.weight, norm_q.bias, norm_q.eps, cos, sin, n_text),
                qk_norm_rope_plain(k, norm_k.weight, norm_k.bias, norm_k.eps, cos, sin, n_text))
    dev = _launch_args(q, k, norm_q, norm_k, cos, sin, n_text)
    if dev is None:
        raise ValueError(f"qk_norm_rope: the kernel does not take q {_layout(q)}, k "
                         f"{_layout(k)}, tables {_layout(cos)} with n_text {n_text}")
    if norm_q.eps != norm_k.eps:
        raise ValueError("qk_norm_rope: the kernel takes one eps for q and k")
    b, s, h, d = q.shape
    lib, fn, raw = _launcher or _load()
    q_out = _build.unfilled((b, s, h, d), q.dtype, q.device)
    k_out = _build.unfilled((b, s, h, d), q.dtype, q.device)
    rc = fn(q.data_ptr(), k.data_ptr(), q_out.data_ptr(), k_out.data_ptr(),
            norm_q.weight.data_ptr(), norm_q.bias.data_ptr(), norm_k.weight.data_ptr(),
            norm_k.bias.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            b, s, h, n_text, float(norm_q.eps), raw(dev))
    if rc:
        _build.check(lib, rc, "qk_norm_rope")
    global LAUNCHES
    LAUNCHES += 1
    return q_out, k_out
