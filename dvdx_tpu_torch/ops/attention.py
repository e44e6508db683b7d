"""Multi-head attention dispatch over (batch, seq, heads, head_dim).

Counterpart of ``dvdx_tpu/ops/attention.py:multi_head_attention``: the one
place every attention of the UNet and the VAE goes through. Self-attention
with S >= 512 and a head dim the flash kernel takes (the UNet's spatial
attn1 at levels 0 and 1) goes to ``ops/kernels/flash_attention``; everything
else (cross-attention over the 77 text tokens, short sequences, the VAE
mid-attention at D = 512) runs the plain math of the reference's
``_xla_attention``: float32 logits and softmax, probabilities cast to V's
dtype, float32-accumulated P.V.

``wants_native_mh`` is the shape gate of the JAX package's opt-in
multi-head-native path (``flash_attention_mh`` on the projections'
head-strip layout). The JAX package leaves that path off by default and the
port has no switch for it, so the model path never routes through it and
computes the same step program.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels.flash_attention import flash_attention, flash_attention_plain

FLASH_MIN_SEQ = 512
FLASH_MAX_HEAD_DIM = 128
MH_MAX_CONTEXT = 512


def wants_flash(s_q: int, s_kv: int, head_dim: int) -> bool:
    return (s_q >= FLASH_MIN_SEQ and s_q == s_kv
            and head_dim <= FLASH_MAX_HEAD_DIM and head_dim % 8 == 0)


def wants_native_mh(s_q: int, s_kv: int, heads: int, head_dim: int) -> bool:
    """True where ``flash_attention_mh`` takes the shapes: self-attention, or
    a context of at most 512 keys, over S_q >= 512 queries with head_dim <=
    128."""
    if head_dim > FLASH_MAX_HEAD_DIM or s_q < FLASH_MIN_SEQ:
        return False
    return s_kv == s_q or s_kv <= MH_MAX_CONTEXT


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v; q: (B, S, H, D), k/v: (B, T, H, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if wants_flash(q.shape[1], k.shape[1], q.shape[-1]):
        return flash_attention(q, k, v, scale)
    return flash_attention_plain(q, k, v, scale)
