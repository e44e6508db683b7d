"""VAE decoder (AutoencoderKL class), channel-last, frame by frame.

Counterpart of ``dvdx_tpu/models/vae.py``: ``VAEDecoder`` and the full-frame
form of ``decode_frames_tiled``. Spatial tiling (``tile > 0`` in the
reference) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ..ops.attention import multi_head_attention
from .layers import Conv, Dense, GroupNorm, upsample_nearest2x

SCALING_FACTOR = 0.18215
GN_EPS = 1e-6  # flax.linen.GroupNorm's default, which the reference's VAE uses


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 4
    base_channels: int = 128
    channel_mults: Tuple[int, ...] = (1, 2, 4, 4)
    layers_per_block: int = 2
    norm_groups: int = 32
    use_mid_attention: bool = True
    # bounded output for random-init models; pretrained loads turn it off
    final_tanh: bool = True
    scaling_factor: float = SCALING_FACTOR
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.channel_mults) - 1)


def tiny_vae_config() -> VAEConfig:
    return VAEConfig(base_channels=16, channel_mults=(1, 2), layers_per_block=1,
                     norm_groups=4, use_mid_attention=False, dtype="float32")


class _VAEResnet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, groups, GN_EPS, act="silu")
        self.conv1 = Conv(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm(out_channels, groups, GN_EPS, act="silu")
        self.conv2 = Conv(out_channels, out_channels, 3, padding=1)
        self.shortcut = (Conv(in_channels, out_channels, 1)
                         if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        return (x if self.shortcut is None else self.shortcut(x)) + h


class _VAEAttention(nn.Module):
    """Single-head self-attention over the H*W positions, residual."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.norm = GroupNorm(channels, groups, GN_EPS)
        self.q = Dense(channels, channels)
        self.k = Dense(channels, channels)
        self.v = Dense(channels, channels)
        self.proj = Dense(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, hh, ww, c = x.shape
        y = self.norm(x).reshape(n, hh * ww, 1, c)
        o = multi_head_attention(self.q(y), self.k(y), self.v(y))
        return x + self.proj(o).reshape(x.shape)


class VAEDecoder(nn.Module):
    """(N, h, w, latent_channels) scaled latents -> (N, H, W, 3) float32 in
    [-1, 1] (tanh) at 2^(levels-1) times the resolution."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        base, mults, g = cfg.base_channels, cfg.channel_mults, cfg.norm_groups
        ch = base * mults[-1]
        self.post_quant_conv = Conv(cfg.latent_channels, cfg.latent_channels, 1)
        self.conv_in = Conv(cfg.latent_channels, ch, 3, padding=1)
        self.mid_res1 = _VAEResnet(ch, ch, g)
        if cfg.use_mid_attention:
            self.mid_attn = _VAEAttention(ch, g)
        self.mid_res2 = _VAEResnet(ch, ch, g)
        for i, mult in reversed(list(enumerate(mults))):
            out_ch = base * mult
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_{j}", _VAEResnet(ch, out_ch, g))
                ch = out_ch
            if i > 0:
                self.add_module(f"up_{i}_conv", Conv(ch, ch, 3, padding=1))
        self.norm_out = GroupNorm(ch, g, GN_EPS, act="silu")
        self.conv_out = Conv(ch, 3, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = self.conv_in.weight.dtype
        h = self.post_quant_conv((z.float() / cfg.scaling_factor).to(dt))
        h = self.mid_res1(self.conv_in(h))
        if cfg.use_mid_attention:
            h = self.mid_attn(h)
        h = self.mid_res2(h)
        for i in reversed(range(len(cfg.channel_mults))):
            for j in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{i}_{j}")(h)
            if i > 0:
                h = getattr(self, f"up_{i}_conv")(upsample_nearest2x(h))
        h = self.conv_out(self.norm_out(h)).float()
        return torch.tanh(h) if cfg.final_tanh else h


def decode_frames_tiled(decoder: VAEDecoder, latents: torch.Tensor) -> torch.Tensor:
    """Decode (F, h, w, C) latents one frame at a time, so peak memory is one
    frame's activations -> (F, H, W, 3) float32. Full-frame decode (the
    reference's ``tile=0``)."""
    return torch.stack([decoder(latents[i:i + 1])[0] for i in range(latents.shape[0])])
