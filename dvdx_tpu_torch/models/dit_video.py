"""Video diffusion transformer (the CogVideoX-class family).

Counterpart of ``dvdx_tpu/models/dit_video.py``: a 3D patch embedding of
channel-last latents, the joint sequence [text tokens ; video tokens] under
full self-attention (no separate cross-attention), 3D rotary phases on the
video tokens over absolute (frame, row, column) patch coordinates, adaLN-zero
timestep modulation, and a zero-initialised output projection. ``VideoDiT``
has the UNet's call, (latents, timesteps, encoder_hidden_states,
frame_positions) -> a prediction of the latents' shape, so the pipeline,
``StepEngine`` and the network roles run it unchanged.

The joint attention goes through ``ops.attention.multi_head_attention``: at
S >= 512 tokens (every full-size geometry: 226 + 48 * 30 * 45 = 65,026 at
cogvideox-5b's native 48 x 720x480) that is the flash kernel on the card.

Rounding points follow the reference: dense layers round their
float32-accumulated product to the compute dtype then add the bias;
LayerNorm statistics are float32 (eps 1e-6, flax's default; ``ln1`` /
``ln2`` carry no scale or bias, ``final_ln`` both); the MLP's GELU is the
tanh approximation; RoPE is applied in float32 and cast back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention
from .layers import Dense, LayerNorm, TimeEmbedding, timestep_embedding

LN_EPS = 1e-6  # flax.linen.LayerNorm's default, which the reference's blocks use


@dataclasses.dataclass(frozen=True)
class DiTVideoConfig:
    in_channels: int = 16
    out_channels: int = 16
    hidden_size: int = 3072
    num_layers: int = 42
    num_heads: int = 48
    patch_size: Tuple[int, int, int] = (1, 2, 2)   # (t, h, w)
    text_hidden_size: int = 4096
    mlp_ratio: float = 4.0
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def tiny_dit_config() -> DiTVideoConfig:
    return DiTVideoConfig(in_channels=4, out_channels=4, hidden_size=64,
                          num_layers=2, num_heads=4, patch_size=(1, 2, 2),
                          text_hidden_size=64, dtype="float32")


def rope_3d(positions_f: torch.Tensor, positions_h: torch.Tensor,
            positions_w: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """3D rotary phase tables (cos, sin), each (S, dim / 2) float32: the
    frame and row axes get (dim // 3) rounded down to even lanes each, the
    column axis the rest, at frequencies 10000^(-i / (d / 2)) per axis."""
    def phases(pos, d):
        freqs = torch.exp(-math.log(10000.0)
                          * torch.arange(d // 2, dtype=torch.float32, device=pos.device)
                          / (d // 2))
        ang = pos.float()[:, None] * freqs[None, :]
        return torch.cos(ang), torch.sin(ang)

    d_f = d_h = (dim // 3) // 2 * 2
    d_w = dim - d_f - d_h
    (cf, sf), (ch, sh), (cw, sw) = (phases(p, d) for p, d in ((positions_f, d_f),
                                                                (positions_h, d_h),
                                                                (positions_w, d_w)))
    return torch.cat([cf, ch, cw], dim=-1), torch.cat([sf, sh, sw], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) rotated by (S, D/2) tables in float32: the halves of D
    become (x1 cos - x2 sin, x1 sin + x2 cos). Result in x's dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without scale or bias: float32 statistics, x's dtype out."""
    return F.layer_norm(x, x.shape[-1:], eps=LN_EPS)


class _DiTBlock(nn.Module):
    """adaLN-zero -> joint self-attention with RoPE on the video tokens ->
    adaLN-modulated tanh-GELU MLP, both gated and residual."""

    def __init__(self, cfg: DiTVideoConfig):
        super().__init__()
        hs = cfg.hidden_size
        self.heads, self.head_dim = cfg.num_heads, cfg.head_dim
        self.adaln_zero = Dense(hs, 6 * hs)
        self.to_q = Dense(hs, hs)
        self.to_k = Dense(hs, hs)
        self.to_v = Dense(hs, hs)
        self.to_out = Dense(hs, hs)
        inner = int(hs * cfg.mlp_ratio)
        self.fc1 = Dense(hs, inner)
        self.fc2 = Dense(inner, hs)

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                rope: Tuple[torch.Tensor, torch.Tensor], n_text: int) -> torch.Tensor:
        shift_a, scale_a, gate_a, shift_m, scale_m, gate_m = \
            self.adaln_zero(F.silu(temb))[:, None, :].chunk(6, dim=-1)
        h = _layer_norm(x) * (1 + scale_a) + shift_a
        b, s, hs = h.shape
        q, k, v = (proj(h).view(b, s, self.heads, self.head_dim)
                   for proj in (self.to_q, self.to_k, self.to_v))
        # rotate the video tokens only; the text tokens keep identity phase
        q = torch.cat([q[:, :n_text], apply_rope(q[:, n_text:], *rope)], dim=1)
        k = torch.cat([k[:, :n_text], apply_rope(k[:, n_text:], *rope)], dim=1)
        o = multi_head_attention(q, k, v).reshape(b, s, hs)
        x = x + gate_a * self.to_out(o)
        h = _layer_norm(x) * (1 + scale_m) + shift_m
        h = self.fc2(F.gelu(self.fc1(h), approximate="tanh"))
        return x + gate_m * h


class VideoDiT(nn.Module):
    """latents (B, F, H, W, in_channels), timesteps (B,), encoder hidden
    states (B, T, text_hidden_size), optional absolute frame positions (F,)
    -> the prediction (v for cogvideox), the latents' shape and dtype."""

    def __init__(self, cfg: DiTVideoConfig):
        super().__init__()
        self.cfg = cfg
        hs = cfg.hidden_size
        pt, ph, pw = cfg.patch_size
        self.patch_embed = Dense(pt * ph * pw * cfg.in_channels, hs)
        self.text_proj = Dense(cfg.text_hidden_size, hs)
        self.time_embedding = TimeEmbedding(hs, hs)
        for i in range(cfg.num_layers):
            self.add_module(f"block{i}", _DiTBlock(cfg))
        self.final_ln = LayerNorm(hs, eps=LN_EPS)
        self.proj_out_zero = Dense(hs, pt * ph * pw * cfg.out_channels)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                frame_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        dt = self.patch_embed.weight.dtype
        b, f, h, w, cin = latents.shape
        pt, ph, pw = cfg.patch_size
        if f % pt or h % ph or w % pw:
            raise ValueError(f"VideoDiT: latents {tuple(latents.shape)} not divisible "
                             f"by the patch {cfg.patch_size}")
        nf, nh, nw = f // pt, h // ph, w // pw
        dev = latents.device
        if frame_positions is None:
            frame_positions = torch.arange(f, device=dev)

        x = latents.to(dt).reshape(b, nf, pt, nh, ph, nw, pw, cin)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, nf * nh * nw, pt * ph * pw * cin)
        x = self.patch_embed(x)
        txt = self.text_proj(encoder_hidden_states.to(dt))
        n_text = txt.shape[1]
        x = torch.cat([txt, x], dim=1)
        temb = self.time_embedding(timestep_embedding(timesteps, cfg.hidden_size))

        # rotary tables over the (frame, row, column) patch coordinates
        patch_frames = frame_positions.to(dev).reshape(nf, pt)[:, 0]
        rope = rope_3d(patch_frames.repeat_interleave(nh * nw),
                       torch.arange(nh, device=dev).repeat_interleave(nw).repeat(nf),
                       torch.arange(nw, device=dev).repeat(nf * nh), cfg.head_dim)
        for i in range(cfg.num_layers):
            x = getattr(self, f"block{i}")(x, temb, rope, n_text)

        x = self.proj_out_zero(self.final_ln(x[:, n_text:]))
        x = x.reshape(b, nf, nh, nw, pt, ph, pw, cfg.out_channels)
        x = x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, f, h, w, cfg.out_channels)
        return x.to(latents.dtype)
