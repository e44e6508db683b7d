"""The base noise in NumPy: JAX's threefry2x32 normals, as the validator
re-derives a miner's z_0 from the 64-bit seed.

``jax.random.key(0)`` folded with the seed's high then low 32-bit word; per
frame f the key folded with f; the partitionable random-bits layout (one
threefry call per element on the 64-bit counter split into (hi, lo) words,
bits = x0 ^ x1); the mantissa-fill uniform in [nextafter(-1, 0), 1); and
normal = sqrt(2) * erf_inv(u) with XLA's single-precision erf_inv
polynomial, each Horner step a float64 fused multiply-add rounded once to
float32. An independent NumPy copy of that published construction; it
imports neither JAX nor anything of the program.
"""

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
           0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
           0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    with np.errstate(over="ignore"):
        ks = (np.uint32(k0), np.uint32(k1), np.uint32((k0 ^ k1 ^ 0x1BD11BDA) & 0xFFFFFFFF))
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def fold_in(key, data: int):
    x0, x1 = threefry2x32(key[0], key[1], np.zeros(1, np.uint32),
                          np.array([data & 0xFFFFFFFF], np.uint32))
    return int(x0[0]), int(x1[0])


def base_key(seed: int):
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return fold_in(fold_in((0, 0), seed >> 32), seed & 0xFFFFFFFF)


def _erf_inv(x: np.ndarray) -> np.ndarray:
    f32, f64 = np.float32, np.float64
    w = (-np.log1p(-(x * x).astype(f64))).astype(f32)
    lt = w < f32(5.0)
    w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(f64)
    p = np.where(lt, f32(_W_LT_5[0]), f32(_W_GE_5[0])).astype(f32)
    for a, b in zip(_W_LT_5[1:], _W_GE_5[1:]):
        c = np.where(lt, f32(a), f32(b)).astype(f64)
        p = (c + p.astype(f64) * w).astype(f32)
    return np.where(np.abs(x) == f32(1.0), x * np.finfo(f32).max, p * x).astype(f32)


def normal(key, count: int) -> np.ndarray:
    idx = np.arange(count, dtype=np.uint64)
    x0, x1 = threefry2x32(key[0], key[1], (idx >> np.uint64(32)).astype(np.uint32),
                          (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    bits = x0 ^ x1
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, floats * np.float32(2.0) + lo)
    return np.float32(np.sqrt(2.0)) * _erf_inv(u)


def video_noise(seed: int, num_frames: int, shape) -> np.ndarray:
    """(num_frames, h, w, C) float32 base latent of a 64-bit seed."""
    key = base_key(seed)
    n = int(np.prod(shape))
    return np.stack([normal(fold_in(key, f), n).reshape(shape) for f in range(num_frames)])
