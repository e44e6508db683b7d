"""Building blocks of the zeroscope UNet3D (diffusers temporal style).

Counterpart of ``dvdx_tpu/models/layers.py`` with the routing the JAX package
intends on its TPU: a BasicTransformerBlock with a text context runs its
post-attn1 tail as ``fused_spatial_tail`` and a ``_TemporalBlock`` runs as
``fused_temporal_block`` where the shape gates below take them (at the
standard geometry: the five level-0 spatial transformers, and
``transformer_in`` and the five level-0 temporal transformers); every other
module runs the reference's unfused branch. The gates read shapes only, not
the device, so the CPU (the kernels' plain versions) and the card compute
one step program. The fused kernels follow the TPU kernels' rounding order,
which is not the unfused branch's. Submodule and parameter names follow the
reference's flax tree on both branches (``utils/bridge.py`` maps it leaf for
leaf).

Layout: activations stay channel-last, (N, H, W, C) per frame and
(B, F, H, W, C) per video, as in the reference; convolutions view them as
``torch.channels_last`` NCHW tensors, which is the layout cuDNN prefers.

bf16 rounding points follow the reference's ``nn.Dense(dtype=...)``: a
linear layer or convolution rounds its float32-accumulated product to the
activation dtype, then adds the bias in that dtype. LayerNorm and GroupNorm
statistics are float32; attention softmax is float32 with probabilities cast
to V's dtype; GELU is the exact-erf form.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention
from ..ops.groupnorm import group_norm_act
from ..ops.kernels.geglu_ff import geglu_ff
from ..ops.kernels import spatial_tail
from ..ops.kernels import temporal_attention as frame_attention
from ..ops.kernels import temporal_block
from ..ops.kernels.spatial_tail import fused_spatial_tail
from ..ops.kernels.temporal_attention import temporal_attention, temporal_attention_plain
from ..ops.kernels.temporal_block import fused_temporal_block

# Shape gates of the kernels (the JAX package's _fused_spatial_tail_wants /
# _fused_block_wants and its fm kernel's limits, without the TPU's VMEM
# choosers). Each takes exactly the shapes its kernel takes:
# * the fused tail at S >= 512 rows per image and the 64-row chain's shapes
#   (C % 64 == 0, C <= 384, heads x head_dim == C with head_dim a multiple
#   of 8 up to 128, a context of <= 512 tokens; the JAX package's streamed
#   C = 640 route is a measured loss and is not taken);
# * the fused block at N >= 64 positions and C % 64 == 0, C <= 384, F <= 64,
#   heads x head_dim == C with head_dim % 8 == 0;
# * frame-axis attention at F <= 128 and head_dim a multiple of 8 up to 128.
# Blocks a gate refuses run unfused, and frame-axis attention the kernel
# refuses runs its plain tensor math, on the card too, as the JAX package
# falls to its XLA branches.
SPATIAL_TAIL_MIN_SEQ = 512
TEMPORAL_BLOCK_MIN_POSITIONS = 64
TEMPORAL_BLOCK_MAX_FRAMES = temporal_block.MAX_FRAMES


def fused_spatial_tail_wants(s: int, dim: int, heads: int, head_dim: int,
                             ctx_tokens: int) -> bool:
    return (s >= SPATIAL_TAIL_MIN_SEQ and dim % 64 == 0
            and dim <= spatial_tail.CHAIN_MAX_DIM and heads * head_dim == dim
            and head_dim % 8 == 0 and 8 <= head_dim <= spatial_tail.MAX_HEAD_DIM
            and 1 <= ctx_tokens <= spatial_tail.MAX_CONTEXT)


def fused_temporal_block_wants(frames: int, positions: int, dim: int, heads: int,
                               head_dim: int) -> bool:
    return (positions >= TEMPORAL_BLOCK_MIN_POSITIONS
            and frames <= TEMPORAL_BLOCK_MAX_FRAMES
            and dim % 64 == 0 and dim <= temporal_block.MAX_DIM
            and heads * head_dim == dim and head_dim % 8 == 0)


def temporal_attention_wants(frames: int, head_dim: int) -> bool:
    return (frames <= frame_attention.MAX_FRAMES and head_dim % 8 == 0
            and 8 <= head_dim <= frame_attention.MAX_HEAD_DIM)


class Dense(nn.Linear):
    """``flax.linen.Dense``: x W^T rounded to x's dtype, then + bias."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class Conv(nn.Conv2d):
    """``flax.linen.Conv`` over channel-last (N, H, W, C): the product
    rounded to x's dtype, then + bias. A (3, 1, 1) temporal conv over
    (B, F, H, W, C) is the same layer with kernel (3, 1) on the
    (B, F, H*W, C) view."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), None,
                     self.stride, self.padding)
        y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class GroupNorm(nn.Module):
    """GroupNorm over every non-leading axis of (N, ..., C), with an optional
    per-sample (N, C) bias added first and an optional SiLU, through
    ``ops.groupnorm.group_norm_act`` (the CUDA kernel on the card)."""

    def __init__(self, channels: int, groups: int, eps: float, act: str = "none"):
        super().__init__()
        self.groups, self.eps, self.act = groups, eps, act
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        return group_norm_act(x, self.weight, self.bias, groups=self.groups,
                              eps=self.eps, act=self.act, bias=bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with float32 statistics, result in x's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (B,) -> (B, dim) float32, cos first."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class TimeEmbedding(nn.Module):
    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.fc1 = Dense(in_dim, time_embed_dim)
        self.fc2 = Dense(time_embed_dim, time_embed_dim)

    def forward(self, sinusoid: torch.Tensor) -> torch.Tensor:
        h = self.fc1(sinusoid.to(self.fc1.weight.dtype))
        return self.fc2(F.silu(h))


class ResnetBlock2D(nn.Module):
    """Per-frame resnet block on (N, H, W, C); both GroupNorm+SiLU pairs,
    and the time-embedding add that feeds norm2, run as one fused GN."""

    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, groups, eps, act="silu")
        self.conv1 = Conv(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = Dense(temb_dim, out_channels)
        self.norm2 = GroupNorm(out_channels, groups, eps, act="silu")
        self.conv2 = Conv(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        t = self.time_emb_proj(F.silu(temb))
        h = self.conv2(self.norm2(h, bias=t))
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return residual + h


class TemporalConvBlock(nn.Module):
    """diffusers TemporalConvLayer: num_layers x (GroupNorm over (F, H, W)
    + SiLU + (3, 1, 1) conv over frames), residual. The last conv is
    zero-initialised (``conv{n-1}_zero``)."""

    def __init__(self, channels: int, num_layers: int = 4, groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            last = i == num_layers - 1
            self.add_module(f"norm{i}", GroupNorm(channels, groups, eps, act="silu"))
            self.add_module(f"conv{i}_zero" if last else f"conv{i}",
                            Conv(channels, channels, (3, 1), padding=(1, 0)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, hh, ww, c = x.shape
        h = x.reshape(b, f, hh * ww, c)
        for i in range(self.num_layers):
            last = i == self.num_layers - 1
            h = getattr(self, f"norm{i}")(h)
            h = getattr(self, f"conv{i}_zero" if last else f"conv{i}")(h)
        return x + h.reshape(x.shape)


class GEGLUFeedForward(nn.Module):
    """diffusers FeedForward(activation_fn='geglu'), mult 4, through the
    ``geglu_ff`` kernels: two wgmma products, the 4x-width inner tensor
    (value times gelu(gate), bf16) written to device memory by the first and
    read back by the second. On the H100 those 2*T*I*2 bytes cost a fraction
    of the products' bound (35 us against 229 us at T = 5760, C = 1280),
    and the split lets both products run 128-token tiles at every width,
    where keeping the inner tensor on chip shrank the tile as C grew."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.proj_in = Dense(dim, dim * mult * 2)
        self.proj_out = Dense(dim * mult, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return geglu_ff(x, self.proj_in.weight, self.proj_in.bias,
                        self.proj_out.weight, self.proj_out.bias)


class Attention(nn.Module):
    """Projected multi-head attention. x: (B, S, C), context: (B, T, Cx)."""

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        kv_dim = context_dim or query_dim
        self.to_q = Dense(query_dim, inner, bias=False)
        self.to_k = Dense(kv_dim, inner, bias=False)
        self.to_v = Dense(kv_dim, inner, bias=False)
        self.to_out = Dense(inner, query_dim)

    def attend(self, x: torch.Tensor,
               context: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The heads' P.V output before the out-projection, (B, S, inner)."""
        ctx = x if context is None else context
        b, s, t = x.shape[0], x.shape[1], ctx.shape[1]
        q = self.to_q(x).view(b, s, self.heads, self.head_dim)
        k = self.to_k(ctx).view(b, t, self.heads, self.head_dim)
        v = self.to_v(ctx).view(b, t, self.heads, self.head_dim)
        o = multi_head_attention(q, k, v)
        return o.reshape(b, s, self.heads * self.head_dim)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.to_out(self.attend(x, context))


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn, LN -> cross-attn over the text context, LN -> GEGLU;
    all residual. Where ``fused_spatial_tail_wants`` takes the shapes,
    everything after attn1's P.V runs as ``fused_spatial_tail``."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int,
                 eps: float = 1e-5):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=eps)
        self.attn1 = Attention(dim, heads, head_dim)
        self.norm2 = LayerNorm(dim, eps=eps)
        self.attn2 = Attention(dim, heads, head_dim, context_dim)
        self.norm3 = LayerNorm(dim, eps=eps)
        self.ff = GEGLUFeedForward(dim)

    def fused(self, x: torch.Tensor, context: torch.Tensor) -> bool:
        return fused_spatial_tail_wants(x.shape[1], x.shape[-1], self.attn1.heads,
                                        self.attn1.head_dim, context.shape[1])

    def tail_params(self) -> dict:
        """The fused tail's flat parameter dict (the JAX keys, nn.Linear
        layout)."""
        a1, a2, ff = self.attn1, self.attn2, self.ff
        return {"o1_w": a1.to_out.weight, "o1_b": a1.to_out.bias,
                "ln2_s": self.norm2.weight, "ln2_b": self.norm2.bias,
                "q2_w": a2.to_q.weight, "o2_w": a2.to_out.weight,
                "o2_b": a2.to_out.bias,
                "ln3_s": self.norm3.weight, "ln3_b": self.norm3.bias,
                "ffi_w": ff.proj_in.weight, "ffi_b": ff.proj_in.bias,
                "ffo_w": ff.proj_out.weight, "ffo_b": ff.proj_out.bias}

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        if self.fused(x, context):
            o1 = self.attn1.attend(self.norm1(x))
            return fused_spatial_tail(
                x, o1, self.attn2.to_k(context), self.attn2.to_v(context),
                self.tail_params(), heads=self.attn1.heads, eps=self.norm2.eps)
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """Per-frame spatial transformer with text cross-attention (diffusers
    Transformer2DModel: GroupNorm(eps=1e-6), 1x1 proj_in/out as dense
    layers, one BasicTransformerBlock). x: (N, H, W, C), context: (N, T, Cx)."""

    def __init__(self, channels: int, heads: int, head_dim: int,
                 context_dim: int, groups: int = 32):
        super().__init__()
        self.norm = GroupNorm(channels, groups, 1e-6)
        self.proj_in = Dense(channels, channels)
        self.block0 = BasicTransformerBlock(channels, heads, head_dim, context_dim)
        self.proj_out_zero = Dense(channels, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        n, hh, ww, c = x.shape
        h = self.proj_in(self.norm(x).reshape(n, hh * ww, c))
        h = self.proj_out_zero(self.block0(h, context))
        return x + h.reshape(x.shape)


class _FrameAxisAttention(nn.Module):
    """Self-attention over the frame axis of frame-major (B, F, N, C), through
    the ``temporal_attention`` kernel: an F x F softmax per (batch, position,
    head), with no transposes of the activations. Where
    ``temporal_attention_wants`` refuses the shape (F > 128), the plain
    tensor math runs instead, on the card too (the JAX layer's XLA einsum)."""

    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__()
        inner = heads * head_dim
        self.heads = heads
        self.to_q = Dense(dim, inner, bias=False)
        self.to_k = Dense(dim, inner, bias=False)
        self.to_v = Dense(dim, inner, bias=False)
        self.to_out = Dense(inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attend = (temporal_attention
                  if temporal_attention_wants(x.shape[1], self.to_q.out_features // self.heads)
                  else temporal_attention_plain)
        return self.to_out(attend(self.to_q(x), self.to_k(x), self.to_v(x), heads=self.heads))


class _TemporalBlock(nn.Module):
    """BasicTransformerBlock on (B, F, N, C) with frame-axis attention in
    attn1 and attn2 (diffusers double_self_attention). Where
    ``fused_temporal_block_wants`` takes the shapes, the whole block runs as
    ``fused_temporal_block``."""

    def __init__(self, dim: int, heads: int, head_dim: int, eps: float = 1e-5):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=eps)
        self.attn1 = _FrameAxisAttention(dim, heads, head_dim)
        self.norm2 = LayerNorm(dim, eps=eps)
        self.attn2 = _FrameAxisAttention(dim, heads, head_dim)
        self.norm3 = LayerNorm(dim, eps=eps)
        self.ff = GEGLUFeedForward(dim)

    def fused(self, x: torch.Tensor) -> bool:
        heads = self.attn1.heads
        return fused_temporal_block_wants(x.shape[1], x.shape[2], x.shape[3], heads,
                                          self.attn1.to_q.out_features // heads)

    def block_params(self) -> dict:
        """The fused block's flat parameter dict (the JAX keys, nn.Linear
        layout)."""
        p = {}
        for i, (norm, attn) in enumerate(((self.norm1, self.attn1),
                                          (self.norm2, self.attn2)), start=1):
            p.update({f"ln{i}_s": norm.weight, f"ln{i}_b": norm.bias,
                      f"q{i}": attn.to_q.weight, f"k{i}": attn.to_k.weight,
                      f"v{i}": attn.to_v.weight, f"o{i}_w": attn.to_out.weight,
                      f"o{i}_b": attn.to_out.bias})
        p.update({"ln3_s": self.norm3.weight, "ln3_b": self.norm3.bias,
                  "ffi_w": self.ff.proj_in.weight, "ffi_b": self.ff.proj_in.bias,
                  "ffo_w": self.ff.proj_out.weight, "ffo_b": self.ff.proj_out.bias})
        return p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused(x):
            return fused_temporal_block(x, self.block_params(),
                                        heads=self.attn1.heads, eps=self.norm1.eps)
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x))
        return x + self.ff(self.norm3(x))


class TransformerTemporal(nn.Module):
    """diffusers TransformerTemporalModel on (B, F, H, W, C): GroupNorm
    (eps=1e-6) with statistics over (F, H, W) jointly, proj_in, one
    _TemporalBlock on the frame-major (B, F, H*W, C) view, zero-init
    proj_out, residual. No positional signal."""

    def __init__(self, channels: int, heads: int, head_dim: int, groups: int = 32):
        super().__init__()
        self.norm = GroupNorm(channels, groups, 1e-6)
        self.proj_in = Dense(channels, channels)
        self.block0 = _TemporalBlock(channels, heads, head_dim)
        self.proj_out_zero = Dense(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, hh, ww, c = x.shape
        h = self.norm(x).reshape(b, f, hh * ww, c)
        h = self.proj_out_zero(self.block0(self.proj_in(h)))
        return x + h.reshape(x.shape)


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest x2 upsampling of (N, H, W, C), then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_nearest2x(x))


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, 2H, 2W, C), each pixel repeated 2x2."""
    up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0, mode="nearest")
    return up.permute(0, 2, 3, 1)
