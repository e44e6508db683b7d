"""The published CogVideoX transformer: diffusers' ``CogVideoXTransformer3DModel``
as THUDM/CogVideoX-5b's ``transformer/config.json`` configures it
(arXiv:2408.06072).

A 2x2 patch embedding of each latent frame and a projection of the T5 text
states make one joint sequence ``[text ; video]``. Each block keeps the two
streams in that one tensor and treats them apart only in its modulations:

* ``norm1`` / ``norm2`` (diffusers' ``CogVideoXLayerNormZero``): one Linear
  of silu(temb) gives six vectors, ``shift, scale, gate, enc_shift,
  enc_scale, enc_gate``; one affine LayerNorm serves both streams, then the
  video rows take ``(1 + scale)`` and ``shift``, the text rows
  ``(1 + enc_scale)`` and ``enc_shift``;
* attention over the whole joint sequence: q, k, v with bias (one fused
  projection here), per-head affine LayerNorm on q and k, the 3D rotary
  embedding on the video positions of q and k (``ops.kernels.qk_norm_rope``),
  softmax scale 1 / sqrt(head_dim) through ``ops.attention.
  multi_head_attention`` (the flash kernel at S >= 512), ``to_out`` with
  bias; the residual adds ``gate`` times the video rows and ``enc_gate``
  times the text rows (``to_out``'s bias and the gated add are one pass,
  ``ops.kernels.dit_epilogue.gated_residual_``);
* the tanh-GELU feed-forward over the joint sequence (its first layer's
  bias and GELU one pass, ``bias_gelu_``), its residual gated the same way
  by the second modulation's gates.

After the blocks, ``norm_final`` (affine LayerNorm) of the video rows,
``norm_out`` (an AdaLayerNorm: silu(temb) -> Linear -> ``shift, scale``),
and ``proj_out`` to p x p x C values a patch, unpatchified with the channels
outermost, as diffusers reads them.

The rotary tables follow diffusers' ``get_3d_rotary_pos_embed`` with real
tables: head_dim / 4 lanes for time, 3 head_dim / 8 each for height and width
(16 / 24 / 24 at 64), frequencies theta^(-2i / d) per axis, cos and sin
repeat-interleaved by 2; positions t = 0..F-1 and the grid's crop region
of the ``sample_height`` x ``sample_width`` latent base (the whole grid at
the native 60 x 90).

``CogVideoXTransformer`` has the UNet's call, (latents (B, F, h, w, C)
channel-last, timesteps (B,), encoder hidden states, optional frame
positions) -> the v prediction in the latents' layout and dtype, so the
pipeline, ``StepEngine`` and the network roles run it unchanged.

Rounding: a dense layer rounds its product to the compute dtype, then adds
its bias (``layers.Dense``), but for the three whose epilogue is fused
(``Dense``'s ``epilogue``): there the bias add, the GELU or the gated
residual add are float32 on the rounded product, rounded once; LayerNorm statistics are float32; the
modulations are one fused multiply-add, rounded once; q/k norm and rotation
are float32, rounded once. The residual stream is updated in place: a
block's forward writes into the tensor it is given.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention
from ..ops.kernels.dit_epilogue import bias_gelu_, gated_residual_
from ..ops.kernels.qk_norm_rope import qk_norm_rope
from ..utils.profiling import span
from .layers import Attention, Dense, LayerNorm, TimeEmbedding, timestep_embedding


QK_NORM_EPS = 1e-6    # diffusers' Attention(eps=1e-6) of norm_q / norm_k
FF_MULT = 4           # FeedForward's inner width, 4 x hidden
ROPE_THETA = 10000.0  # get_3d_rotary_pos_embed's base


@dataclasses.dataclass(frozen=True)
class CogVideoXConfig:
    in_channels: int = 16
    out_channels: int = 16
    num_layers: int = 42
    num_heads: int = 48
    head_dim: int = 64
    time_embed_dim: int = 512
    text_embed_dim: int = 4096
    patch_size: int = 2
    norm_eps: float = 1e-5
    sample_height: int = 60     # the latent base grid the rotary crop region is taken on
    sample_width: int = 90
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def hidden_size(self) -> int:
        return self.num_heads * self.head_dim


def tiny_cogvideox_config() -> CogVideoXConfig:
    """CPU-test scale: hidden 128 as 2 heads of the published 64 lanes (so
    the 16 / 24 / 24 rotary split holds), 2 blocks, a base grid of 8 x 12."""
    return CogVideoXConfig(num_layers=2, num_heads=2, time_embed_dim=32, text_embed_dim=64,
                           sample_height=8, sample_width=12, dtype="float32")


def crop_region(grid: Tuple[int, int], base_w: int, base_h: int):
    """diffusers' ``get_resize_crop_region_for_grid``: the region of a
    (base_h, base_w) grid that a (h, w) grid covers, resized to fit and
    centred: ((top, left), (bottom, right))."""
    h, w = grid
    if h / w > base_h / base_w:
        rh, rw = base_h, int(round(base_h / h * w))
    else:
        rw, rh = base_w, int(round(base_w / w * h))
    top, left = int(round((base_h - rh) / 2.0)), int(round((base_w - rw) / 2.0))
    return (top, left), (top + rh, left + rw)


def rope_tables(cfg: CogVideoXConfig, frames: int, grid_h: int, grid_w: int,
                frame_positions: Optional[torch.Tensor] = None):
    """(cos, sin), each (frames * grid_h * grid_w, head_dim) float32 on the
    CPU, rows frame-major then row then column."""
    d = cfg.head_dim
    p = cfg.patch_size
    (top, left), (bottom, right) = crop_region((grid_h, grid_w), cfg.sample_width // p,
                                               cfg.sample_height // p)
    pos_t = (torch.arange(frames, dtype=torch.float32, device="cpu") if frame_positions is None
             else frame_positions.detach().float().cpu())
    pos_h = torch.from_numpy(np.linspace(top, bottom, grid_h, endpoint=False, dtype=np.float32))
    pos_w = torch.from_numpy(np.linspace(left, right, grid_w, endpoint=False, dtype=np.float32))

    def axis(pos, dim):
        freqs = 1.0 / (ROPE_THETA ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                                   device="cpu")[: dim // 2] / dim))
        ang = torch.outer(pos, freqs)
        return ang.cos().repeat_interleave(2, dim=1), ang.sin().repeat_interleave(2, dim=1)

    parts = [axis(pos_t, d // 4), axis(pos_h, d // 8 * 3), axis(pos_w, d // 8 * 3)]
    shape = (frames, grid_h, grid_w)
    out = []
    for j in range(2):
        t, h, w = (x[j] for x in parts)
        out.append(torch.cat([t[:, None, None].expand(*shape, -1),
                              h[None, :, None].expand(*shape, -1),
                              w[None, None, :].expand(*shape, -1)], dim=-1).reshape(-1, d))
    return out[0], out[1]


def _modulate_(h: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> None:
    """h <- h * (1 + scale) + shift in place, one rounding."""
    torch.addcmul(shift, h, 1 + scale, out=h)


def _gated_into(residual: torch.Tensor, gate: torch.Tensor, enc_gate: torch.Tensor,
                n_text: int):
    """A ``Dense`` epilogue: residual += g * (y + b), g = gate on the video
    rows and enc_gate on the text rows, in one pass; the residual, updated
    in place, returned."""
    return lambda y, b: gated_residual_(residual, y, b, gate, enc_gate, n_text)


class _LayerNormZero(nn.Module):
    """diffusers' ``CogVideoXLayerNormZero`` over the joint sequence."""

    def __init__(self, temb_dim: int, dim: int, eps: float):
        super().__init__()
        self.linear = Dense(temb_dim, 6 * dim)
        self.norm = LayerNorm(dim, eps=eps)

    def forward(self, x: torch.Tensor, emb: torch.Tensor, n_text: int):
        """x (B, S, C) joint, emb = silu(temb) -> (the modulated norm of x,
        gate, enc_gate), the gates (B, 1, C)."""
        shift, scale, gate, enc_shift, enc_scale, enc_gate = \
            self.linear(emb)[:, None].chunk(6, dim=-1)
        h = self.norm(x)
        _modulate_(h[:, n_text:], scale, shift)
        _modulate_(h[:, :n_text], enc_scale, enc_shift)
        return h, gate, enc_gate


class JointAttention(Attention):
    """Self-attention over the joint sequence with QK-LayerNorm and the
    rotary embedding on the video positions. An ``Attention`` by interface
    (``heads``, ``head_dim``, a forward over (B, S, C) with no context), with
    its own projections: one fused q/k/v Dense with bias (diffusers'
    ``to_q``, ``to_k``, ``to_v`` stacked), ``norm_q``, ``norm_k`` and
    ``to_out``, whose output its block's gates add to the residual stream
    in the same pass."""

    def __init__(self, dim: int, heads: int, head_dim: int, eps: float):
        nn.Module.__init__(self)
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_qkv = Dense(dim, 3 * inner)
        self.norm_q = LayerNorm(head_dim, eps=eps)
        self.norm_k = LayerNorm(head_dim, eps=eps)
        self.to_out = Dense(inner, dim)

    def forward(self, x: torch.Tensor, *, rope: Tuple[torch.Tensor, torch.Tensor],
                n_text: int, residual: torch.Tensor, gate: torch.Tensor,
                enc_gate: torch.Tensor) -> torch.Tensor:
        """x (B, S, C) the modulated joint sequence; ``residual`` += the
        gated ``to_out`` of the attention, in place, and returned."""
        b, s, _ = x.shape
        qkv = self.to_qkv(x).view(b, s, 3, self.heads, self.head_dim)
        q, k = qk_norm_rope(qkv[:, :, 0], qkv[:, :, 1], self.norm_q, self.norm_k, *rope, n_text)
        o = multi_head_attention(q, k, qkv[:, :, 2], scale=self.head_dim ** -0.5)
        return self.to_out(o.reshape(b, s, self.heads * self.head_dim),
                           epilogue=_gated_into(residual, gate, enc_gate, n_text))


class _FeedForward(nn.Module):
    """diffusers' ``FeedForward(activation_fn="gelu-approximate")``, its
    output added to the residual stream through the block's gates."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj_in = Dense(dim, inner)
        self.proj_out = Dense(inner, dim)

    def forward(self, x: torch.Tensor, residual: torch.Tensor, gate: torch.Tensor,
                enc_gate: torch.Tensor, n_text: int) -> torch.Tensor:
        h = self.proj_in(x, epilogue=bias_gelu_)
        return self.proj_out(h, epilogue=_gated_into(residual, gate, enc_gate, n_text))


class CogVideoXBlock(nn.Module):
    def __init__(self, cfg: CogVideoXConfig):
        super().__init__()
        c = cfg.hidden_size
        self.norm1 = _LayerNormZero(cfg.time_embed_dim, c, cfg.norm_eps)
        self.attn1 = JointAttention(c, cfg.num_heads, cfg.head_dim, QK_NORM_EPS)
        self.norm2 = _LayerNormZero(cfg.time_embed_dim, c, cfg.norm_eps)
        self.ff = _FeedForward(c, FF_MULT * c)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                rope: Tuple[torch.Tensor, torch.Tensor], n_text: int) -> torch.Tensor:
        """x (B, S, C) joint, updated in place and returned."""
        with span("dit.attn"):
            h, gate, enc_gate = self.norm1(x, emb, n_text)
            self.attn1(h, rope=rope, n_text=n_text, residual=x, gate=gate, enc_gate=enc_gate)
        with span("dit.ff"):
            h, gate, enc_gate = self.norm2(x, emb, n_text)
            self.ff(h, x, gate, enc_gate, n_text)
        return x


class _AdaLayerNorm(nn.Module):
    """diffusers' ``AdaLayerNorm(chunk_dim=1)``: ``shift, scale`` in that order."""

    def __init__(self, temb_dim: int, dim: int, eps: float):
        super().__init__()
        self.linear = Dense(temb_dim, 2 * dim)
        self.norm = LayerNorm(dim, eps=eps)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        shift, scale = self.linear(emb)[:, None].chunk(2, dim=-1)
        h = self.norm(x)
        _modulate_(h, scale, shift)
        return h


class CogVideoXTransformer(nn.Module):
    """latents (B, F, h, w, in_channels) channel-last, timesteps (B,), T5
    states (B, T, text_embed_dim), optional frame positions (F,) -> the v
    prediction, the latents' shape and dtype."""

    def __init__(self, cfg: CogVideoXConfig):
        super().__init__()
        self.cfg = cfg
        c, p = cfg.hidden_size, cfg.patch_size
        # the Conv2d(in, C, p, stride p) as a Dense over each patch's
        # (channel, row, column) values: the conv kernel reshaped, no reorder
        self.patch_embed = Dense(cfg.in_channels * p * p, c)
        self.text_proj = Dense(cfg.text_embed_dim, c)
        self.time_embedding = TimeEmbedding(c, cfg.time_embed_dim)
        for i in range(cfg.num_layers):
            self.add_module(f"block{i}", CogVideoXBlock(cfg))
        self.norm_final = LayerNorm(c, eps=cfg.norm_eps)
        self.norm_out = _AdaLayerNorm(cfg.time_embed_dim, c, cfg.norm_eps)
        self.proj_out = Dense(c, p * p * cfg.out_channels)
        self._tables: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def rope(self, frames: int, grid_h: int, grid_w: int, device,
             frame_positions: Optional[torch.Tensor] = None):
        """The rotary tables on ``device`` as (S_video, 1, head_dim), kept
        per geometry (tables of given frame positions are not kept)."""
        key = (frames, grid_h, grid_w, str(device))
        if frame_positions is None and key in self._tables:
            return self._tables[key]
        cos, sin = (t[:, None].to(device) for t in rope_tables(self.cfg, frames, grid_h, grid_w,
                                                               frame_positions))
        if frame_positions is None:
            self._tables[key] = (cos, sin)
        return cos, sin

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                frame_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        dt = self.patch_embed.weight.dtype
        b, f, h, w, cin = latents.shape
        p = cfg.patch_size
        if h % p or w % p:
            raise ValueError(f"CogVideoXTransformer: latents {tuple(latents.shape)} not "
                             f"divisible by the patch {p}")
        nh, nw = h // p, w // p
        with span("dit"):
            with span("dit.embed"):
                emb = F.silu(self.time_embedding(timestep_embedding(timesteps,
                                                                    cfg.hidden_size)))
                x = latents.to(dt).reshape(b, f, nh, p, nw, p, cin)
                x = x.permute(0, 1, 2, 4, 6, 3, 5).reshape(b, f * nh * nw, cin * p * p)
                txt = self.text_proj(encoder_hidden_states.to(dt))
                n_text = txt.shape[1]
                x = torch.cat([txt, self.patch_embed(x)], dim=1)
                rope = self.rope(f, nh, nw, latents.device, frame_positions)
            for i in range(cfg.num_layers):
                with span("dit.block"):
                    x = getattr(self, f"block{i}")(x, emb, rope, n_text)
            with span("dit.out"):
                x = self.proj_out(self.norm_out(self.norm_final(x[:, n_text:]), emb))
                x = x.reshape(b, f, nh, nw, cfg.out_channels, p, p)
                x = x.permute(0, 1, 2, 5, 3, 6, 4).reshape(b, f, h, w, cfg.out_channels)
                return x.to(latents.dtype)

