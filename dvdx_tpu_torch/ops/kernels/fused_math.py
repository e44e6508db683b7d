"""Plain PyTorch pieces shared by the fused kernels' plain versions
(``spatial_tail``, ``temporal_block``), with the JAX kernels' rounding points:
products accumulate in float32 and round to the activation dtype where
``nn.Dense`` materialises, LayerNorm has float32 fast-variance moments, and
the GEGLU residual adds the FF output bias in float32 before its one
rounding. Weights use ``nn.Linear``'s (out, in) layout; vectors keep the
dtype they are given (float32 in the JAX kernels), weights are cast to the
activation dtype.
"""

from __future__ import annotations

import math

import torch


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x W^T, float32 accumulation, rounded to x's dtype."""
    return (x.float() @ w.to(x.dtype).float().t()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """flax LayerNorm: mean and E[x^2] - mean^2 in float32, result in x's
    dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def geglu_residual(h: torch.Tensor, x: torch.Tensor, w_in: torch.Tensor,
                   b_in: torch.Tensor, w_out: torch.Tensor,
                   b_out: torch.Tensor) -> torch.Tensor:
    """x + round(((h Wv + bv) * gelu(h Wg + bg)) Wo + bo): value and gate
    rounded to h's dtype, exact-erf GELU, the f32 product sum plus the f32
    output bias rounded once, then added to x."""
    dt = h.dtype
    inner = w_in.shape[0] // 2
    hg = h.float() @ w_in.to(dt).float().t() + b_in.float()
    val = hg[..., :inner].to(dt).float()
    gate = hg[..., inner:].to(dt).float()
    act = val * (0.5 * gate * (1.0 + torch.erf(gate * (1.0 / math.sqrt(2.0)))))
    acc = act.to(dt).float() @ w_out.to(dt).float().t()
    return x + (acc + b_out.float()).to(dt)
