"""Ring and Ulysses attention over a frame axis sharded on a process group.

Counterpart of ``dvdx_tpu/ops/ring_attention.py``. Each rank holds its
contiguous block of the sequence, (B, S/n, H, D), on the mesh's ``seq``
subgroup.

* ``ring_attention``: the K/V blocks rotate one hop per step around the
  ring (``dist.batch_isend_irecv`` to the next rank, from the previous);
  each rank merges the block statistics of its queries in float32 -- running
  max m, denominator l and unnormalised output o, rescaled by exp(m - m_new)
  as in the reference's ``_ring_body`` -- and divides once at the end. Exact
  global attention up to float32 accumulation order.
* ``ulysses_attention``: one ``all_to_all_single`` re-shards (B, S/n, H, D)
  to (B, S, H/n, D), every rank runs whole-sequence attention over its
  heads, and a second all-to-all shards the sequence back. Heads must divide
  the group size.

The local block is plain tensor math (the reference's ``_xla_attention``,
which is not a Pallas kernel): float32 logits and softmax, probabilities in
V's dtype, a float32-accumulated P.V.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .kernels.flash_attention import flash_attention_plain


def _local_block(q, k, v, scale: float):
    """Block statistics of q (B, Sq, H, D) against one K/V block: the
    unnormalised output (B, Sq, H, D), the row max m and the denominator l
    (B, H, Sq, 1), all float32."""
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhst,bthd->bshd", p.to(v.dtype).float(), v.float())
    return o, m, l


def _rotate(t: torch.Tensor, ranks: Sequence[int], pos: int, group) -> torch.Tensor:
    """Send t to the next rank of ``ranks``, receive the previous rank's."""
    n = len(ranks)
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t.contiguous(), ranks[(pos + 1) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(pos - 1) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
                   axis_name: str = "seq", scale: Optional[float] = None) -> torch.Tensor:
    """Global self-attention with the sequence sharded over ``axis_name``:
    q, k, v are this rank's (B, S/n, H, D) blocks; returns its block of the
    output, in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    axes = (axis_name,)
    group, ranks = mesh.group(axes), mesh.global_ranks(axes)
    pos = mesh.index(axes)
    o, m, l = _local_block(q, k, v, scale)
    kv = torch.stack([k, v])  # one message a hop
    for _ in range(len(ranks) - 1):
        kv = _rotate(kv, ranks, pos, group)
        o_b, m_b, l_b = _local_block(q, kv[0], kv[1], scale)
        m_new = torch.maximum(m, m_b)
        alpha, beta = torch.exp(m - m_new), torch.exp(m_b - m_new)
        # statistics are (B, H, Sq, 1), outputs (B, Sq, H, D)
        o = o * alpha.permute(0, 2, 1, 3) + o_b * beta.permute(0, 2, 1, 3)
        l = l * alpha + l_b * beta
        m = m_new
    return (o / l.permute(0, 2, 1, 3)).to(q.dtype)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """all_to_all_single over dim 0 of x (n, ...): row j goes to rank j,
    row j of the result comes from rank j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
                      axis_name: str = "seq", scale: Optional[float] = None) -> torch.Tensor:
    """Global self-attention, sequence sharded over ``axis_name``, by head
    all-to-all: q, k, v (B, S/n, H, D) -> this rank's (B, S/n, H, D) block.
    H must divide the group size (route other shapes to ring_attention)."""
    n = mesh.shape[axis_name]
    b, s_loc, h, d = q.shape
    if h % n:
        raise ValueError(
            f"ulysses needs heads ({h}) divisible by the mesh axis ({n}); use "
            "ring_attention (or cp_algo='auto') instead")
    if scale is None:
        scale = d ** -0.5
    group = mesh.group((axis_name,))
    hl = h // n

    def to_heads(x):  # (B, S/n, H, D) -> (B, S, H/n, D)
        parts = x.reshape(b, s_loc, n, hl, d).permute(2, 0, 1, 3, 4)  # (n, B, S/n, H/n, D)
        got = _all_to_all(parts, group)   # [j] = rank j's frames, my heads
        return got.permute(1, 0, 2, 3, 4).reshape(b, n * s_loc, hl, d)

    o = flash_attention_plain(to_heads(q), to_heads(k), to_heads(v), scale)
    # back: split the sequence, gather the heads
    parts = o.reshape(b, n, s_loc, hl, d).permute(1, 0, 2, 3, 4)  # (n, B, S/n, H/n, D)
    got = _all_to_all(parts, group)       # [j] = my frames, rank j's heads
    return got.permute(1, 2, 0, 3, 4).reshape(b, s_loc, h, d)


def frame_halo(x: torch.Tensor, mesh, axis_name: str = "seq") -> torch.Tensor:
    """(B, F/n, ...) -> (B, F/n + 2, ...): this rank's frames between its
    neighbours' edge frames (the previous rank's last, the next rank's
    first), zeros at the video's ends, as a (3, 1) temporal conv with frame
    padding 1 sees them on one device."""
    axes = (axis_name,)
    group, ranks = mesh.group(axes), mesh.global_ranks(axes)
    pos, n = mesh.index(axes), len(ranks)
    first, last = x[:, :1].contiguous(), x[:, -1:].contiguous()
    from_prev, from_next = torch.zeros_like(first), torch.zeros_like(last)
    ops = []
    if pos > 0:
        ops += [dist.P2POp(dist.isend, first, ranks[pos - 1], group),
                dist.P2POp(dist.irecv, from_prev, ranks[pos - 1], group)]
    if pos < n - 1:
        ops += [dist.P2POp(dist.isend, last, ranks[pos + 1], group),
                dist.P2POp(dist.irecv, from_next, ranks[pos + 1], group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([from_prev, x, from_next], dim=1)
