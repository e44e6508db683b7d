"""Counter-based base noise, the counterpart of ``dvdx_tpu/ops/rng.py``.

The validator re-derives a miner's base latent z_0 from the 64-bit seed alone
(``dvdx_tpu/verify/spotcheck.py``), so the port draws exactly JAX's bits and
uniforms, and normals within 3 float32 ulps of JAX's (see ``erf_inv``):
threefry2x32 keys (``jax.random.key`` / ``fold_in``), the partitionable
random-bits layout of JAX 0.9 (``jax_threefry_partitionable=True``: one
threefry call per element on the 64-bit counter split into (hi, lo) words,
bits = x0 ^ x1), the mantissa-fill uniform in [nextafter(-1, 0), 1), and
``normal = sqrt(2) * erf_inv(u)`` with XLA's single-precision erf_inv
polynomial. All integer work is int64 tensor arithmetic masked to 32 bits,
on the caller's device.

A key is a (2,) int64 tensor holding two uint32 words.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ..utils.profiling import span

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds (JAX's ``_threefry2x32_lowering``).
    k0, k1: key words; x0, x1: int64 tensors of uint32 counter words."""
    ks = (k0 & _MASK, k1 & _MASK, (k0 ^ k1 ^ 0x1BD11BDA) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _key(words: Sequence[int]) -> torch.Tensor:
    return torch.tensor([int(w) & _MASK for w in words], dtype=torch.int64)


def key(seed: int) -> torch.Tensor:
    """``jax.random.key(seed)``: the words (seed >> 32, seed & 0xFFFFFFFF)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return _key((seed >> 32, seed & _MASK))


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: threefry over the counter pair (0, data)."""
    k0, k1 = (int(w) for w in key.tolist())
    x0, x1 = threefry2x32(k0, k1, torch.zeros(1, dtype=torch.int64),
                          torch.tensor([int(data) & _MASK], dtype=torch.int64))
    return _key((x0.item(), x1.item()))


def base_key(seed: int) -> torch.Tensor:
    """64-bit seed -> key, as ``base_key`` of ``dvdx_tpu/ops/rng.py``: key(0)
    folded with the seed's high then low 32-bit word."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return fold_in(fold_in(key(0), seed >> 32), seed & _MASK)


def random_bits(key: torch.Tensor, shape: Sequence[int],
                device="cuda") -> torch.Tensor:
    """32-bit random words (int64 tensor) in JAX's partitionable layout."""
    k0, k1 = (int(w) for w in key.tolist())
    count = int(np.prod(shape))
    idx = torch.arange(count, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(k0, k1, idx >> 32, idx & _MASK)
    return (x0 ^ x1).reshape(tuple(shape))


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """JAX's f32 uniform in [nextafter(-1, 0), 1): mantissa fill -> [1, 2),
    minus 1, times (hi - lo) = 2, plus lo, clamped below at lo."""
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    # a blocking copy to the card where bits live there
    with span("wait.scalar_upload"):
        lo = torch.tensor(np.nextafter(np.float32(-1.0), np.float32(0.0)),
                          dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, floats * 2.0 + lo)


# XLA ErfInv for f32 (Giles, "Approximating the erfinv function")
_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
           0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
           1.50140941)
_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
           0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
           2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """Single-precision erf_inv with XLA's coefficients and evaluation
    order; |x| == 1 maps to +-inf. log1p is taken in float64 and rounded
    once, so CPU and CUDA give the same bits. Matches XLA's CPU result to
    within 3 f32 ulps (about 1% of values differ): XLA's own float32 log1p
    is not correctly rounded. Rounded to bfloat16, the latent dtype, such a
    difference now and then crosses a rounding boundary: the bf16 base
    latent differs from the reference's by one bf16 ulp in a few elements
    at some seeds (7 of seeds 0-599 at (16, 40, 72, 4)), which the
    validator's cross-platform tolerance absorbs."""
    w = -torch.log1p(-(x * x).double()).float()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(lt, torch.full_like(x, _W_LT_5[0]), torch.full_like(x, _W_GE_5[0]))
    for a, b in zip(_W_LT_5[1:], _W_GE_5[1:]):
        c = torch.where(lt, torch.full_like(x, a), torch.full_like(x, b))
        # XLA evaluates each Horner step as one fused multiply-add: an exact
        # product and sum in f64, rounded once to f32
        p = (c.double() + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, p * x)


def normal(key: torch.Tensor, shape: Sequence[int], device="cuda") -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``."""
    u = uniform_from_bits(random_bits(key, shape, device))
    return torch.tensor(math.sqrt(2.0), dtype=torch.float32) * erf_inv(u)


def frame_noise(key: torch.Tensor, frame_idx: int, shape: Sequence[int],
                device="cuda") -> torch.Tensor:
    """N(0, 1) noise (f32) for one frame of per-frame latent shape (h, w, C)."""
    return normal(fold_in(key, frame_idx), shape, device)


def frame_range_noise(key: torch.Tensor, start: int, num_frames: int,
                      shape: Sequence[int], device="cuda") -> torch.Tensor:
    """Noise of frames [start, start + num_frames), stacked on axis 0: rows
    start.. of ``video_noise`` (a chunk worker draws only its own frames)."""
    return torch.stack([frame_noise(key, start + f, shape, device)
                        for f in range(num_frames)])


def video_noise(key: torch.Tensor, num_frames: int, shape: Sequence[int],
                device="cuda") -> torch.Tensor:
    """Base latent (num_frames, h, w, C) f32 for a key."""
    return frame_range_noise(key, 0, num_frames, shape, device)


AUX_SALT = 0xAE0B5EED  # keeps aux streams disjoint from frame-index folds


def aux_noise(key: torch.Tensor, x: torch.Tensor, tag: int) -> torch.Tensor:
    """An auxiliary deterministic stream of x's shape on x's device (the
    img2vid conditioning augmentation, tag 7): ``jax.random.normal`` under
    ``key`` folded with ``AUX_SALT`` then ``tag``, float32. The salt keeps
    it apart from ``frame_noise``'s fold_in(frame index): without it, tag t
    would be base-noise frame t."""
    if x.dtype != torch.float32:
        raise ValueError("aux_noise: the reference draws this stream in float32")
    return normal(fold_in(fold_in(key, AUX_SALT), tag), x.shape, device=x.device)
