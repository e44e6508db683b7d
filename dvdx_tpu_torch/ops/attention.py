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

``ring_context`` (the JAX module's, on a ``parallel.mesh.Mesh``) marks a
region whose frame axis is sharded over the mesh's ``seq`` group: there a
call with ``impl="ring"`` runs ``ops.ring_attention`` (ring, Ulysses, or
Ulysses where the heads divide the group and ring elsewhere), and the layers
take their frame-sharded routes (``ring_active``). Outside a ring context
``impl="ring"`` is the default dispatch, so the single-device step program
does not change.
"""

from __future__ import annotations

import contextlib
import contextvars
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


# A ContextVar, not a module global: a step program built on another thread
# (the mock network's miners run in a thread pool) must not see this one's
# ring context.
_RING_CTX: contextvars.ContextVar[tuple] = contextvars.ContextVar("dvdx_ring_ctx",
                                                                   default=())


@contextlib.contextmanager
def ring_context(mesh, axis_name: str = "seq", algo: str = "ring"):
    """Inside this context the frame axis is sharded over ``axis_name`` of
    ``mesh``, and attention calls with impl='ring' run as exact context
    parallelism. algo: 'ring' (any head count), 'ulysses' (raises on heads
    that do not divide the group) or 'auto' (Ulysses where they divide,
    ring elsewhere)."""
    if algo not in ("ring", "ulysses", "auto"):
        raise ValueError(f"unknown cp algo {algo!r}")
    token = _RING_CTX.set(_RING_CTX.get() + ((mesh, axis_name, algo),))
    try:
        yield
    finally:
        _RING_CTX.reset(token)


def ring_active() -> bool:
    """True inside a ring_context: the layers take their frame-sharded
    routes (no fused temporal block or spatial tail, no frame-axis kernel,
    GroupNorm moments and conv halos across the seq group)."""
    return bool(_RING_CTX.get())


def ring_mesh():
    """(mesh, axis_name) of the innermost ring context, or None."""
    stack = _RING_CTX.get()
    return (stack[-1][0], stack[-1][1]) if stack else None


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         scale: Optional[float] = None, impl: str = "auto") -> torch.Tensor:
    """softmax(q k^T * scale) v; q: (B, S, H, D), k/v: (B, T, H, D).
    impl 'ring' runs ring / Ulysses attention inside a ring context with a
    seq group of more than one rank, and the default dispatch elsewhere."""
    if impl == "ring":
        stack = _RING_CTX.get()
        if stack and q.shape[1] == k.shape[1]:
            mesh, axis_name, algo = stack[-1]
            n = mesh.shape[axis_name]
            if n > 1:
                from .ring_attention import ring_attention, ulysses_attention

                if algo == "ulysses" or (algo == "auto" and q.shape[2] % n == 0):
                    return ulysses_attention(q, k, v, mesh, axis_name=axis_name,
                                             scale=scale)
                return ring_attention(q, k, v, mesh, axis_name=axis_name, scale=scale)
    elif impl != "auto":
        raise ValueError(f"multi_head_attention: unknown impl {impl!r}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if wants_flash(q.shape[1], k.shape[1], q.shape[-1]):
        return flash_attention(q, k, v, scale)
    return flash_attention_plain(q, k, v, scale)
