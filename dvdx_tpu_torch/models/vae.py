"""VAE (AutoencoderKL class), channel-last, frame by frame.

Counterpart of ``dvdx_tpu/models/vae.py``: ``VAEDecoder`` and
``decode_frames_tiled``, full frame or in overlapping spatial tiles blended
by linear ramps (``decode_frame_spatially_tiled``: peak memory one tile's
activations instead of one frame's), and ``VAEEncoder`` (the img2vid
family's conditioning latent). Every GroupNorm runs through the port's
``GroupNorm`` (the ``group_norm_act`` kernel on the card).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
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
        h = self.norm2(self.conv1(self.norm1(x)))
        return self.conv2(h, residual=x if self.shortcut is None else self.shortcut(x))


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
        return self.proj(o, residual=x.reshape(y.shape)).reshape(x.shape)


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


class VAEEncoder(nn.Module):
    """(N, H, W, 3) images in [-1, 1] -> the latent mean (N, H/d, W/d,
    latent_channels) float32, times the scaling factor (no sampling)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        base, mults, g = cfg.base_channels, cfg.channel_mults, cfg.norm_groups
        self.conv_in = Conv(3, base, 3, padding=1)
        ch = base
        for i, mult in enumerate(mults):
            out_ch = base * mult
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_{j}", _VAEResnet(ch, out_ch, g))
                ch = out_ch
            if i < len(mults) - 1:
                self.add_module(f"down_{i}_conv", Conv(ch, ch, 3, stride=2, padding=1))
        self.mid_res1 = _VAEResnet(ch, ch, g)
        if cfg.use_mid_attention:
            self.mid_attn = _VAEAttention(ch, g)
        self.mid_res2 = _VAEResnet(ch, ch, g)
        self.norm_out = GroupNorm(ch, g, GN_EPS, act="silu")
        self.conv_mean = Conv(ch, cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = self.conv_in(x.to(self.conv_in.weight.dtype))
        for i in range(len(cfg.channel_mults)):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_{j}")(h)
            if i < len(cfg.channel_mults) - 1:
                h = getattr(self, f"down_{i}_conv")(h)
        h = self.mid_res1(h)
        if cfg.use_mid_attention:
            h = self.mid_attn(h)
        h = self.mid_res2(h)
        return self.conv_mean(self.norm_out(h)).float() * cfg.scaling_factor


def _tile_starts(size: int, tile: int, stride: int) -> List[int]:
    """Tile start offsets covering [0, size), the last tile right-aligned
    (every pixel covered, one tile shape)."""
    starts = list(range(0, max(size - tile, 0) + 1, stride))
    if not starts or starts[-1] + tile < size:
        starts.append(size - tile)
    return sorted(set(max(0, s) for s in starts))


def _blend_weight_1d(size: int, start: int, total: int, overlap: int) -> np.ndarray:
    """Linear ramps into and out of a tile's overlapped borders: adjacent
    tiles laid out by ``_tile_starts`` with stride tile - overlap sum to 1."""
    w = np.ones(size, np.float32)
    ramp = ((np.arange(overlap) + 1) / (overlap + 1)).astype(np.float32)
    if start > 0 and overlap > 0:
        w[:overlap] = ramp
    if start + size < total and overlap > 0:
        w[-overlap:] = np.minimum(w[-overlap:], ramp[::-1])
    return w


def decode_frame_spatially_tiled(decoder: VAEDecoder, z_frame: torch.Tensor,
                                 tile: int = 48, overlap: int = 8) -> torch.Tensor:
    """Decode one latent frame (h, w, C) in overlapping tiles of tile x tile
    latent pixels, each weighted by ramps over its overlapped borders and
    the sum normalised -> (H, W, 3) float32. Approximate at the seams (each
    tile's GroupNorms see their own statistics); a single covering tile is
    the full-frame decode exactly."""
    upscale = decoder.cfg.downscale
    h, w, c = z_frame.shape
    tile_h, tile_w = min(tile, h), min(tile, w)
    hs = _tile_starts(h, tile_h, max(1, tile_h - overlap))
    ws = _tile_starts(w, tile_w, max(1, tile_w - overlap))
    if len(hs) == 1 and len(ws) == 1:
        return decoder(z_frame[None])[0]
    big_h, big_w = h * upscale, w * upscale
    th, tw = tile_h * upscale, tile_w * upscale
    out = torch.zeros((big_h, big_w, 3), dtype=torch.float32, device=z_frame.device)
    norm = torch.zeros((big_h, big_w, 1), dtype=torch.float32, device=z_frame.device)
    for sh in hs:
        for sw in ws:
            img = decoder(z_frame[None, sh:sh + tile_h, sw:sw + tile_w])[0]
            wh = _blend_weight_1d(th, sh * upscale, big_h, overlap * upscale)
            ww = _blend_weight_1d(tw, sw * upscale, big_w, overlap * upscale)
            mask = torch.from_numpy(wh[:, None] * ww[None, :])[..., None].to(out.device)
            rows = slice(sh * upscale, sh * upscale + th)
            cols = slice(sw * upscale, sw * upscale + tw)
            out[rows, cols] = out[rows, cols] + img.float() * mask
            norm[rows, cols] = norm[rows, cols] + mask
    return out / torch.clamp(norm, min=1e-6)


def decode_frames_tiled(decoder: VAEDecoder, latents: torch.Tensor, tile: int = 0,
                        overlap: int = 8) -> torch.Tensor:
    """Decode (F, h, w, C) latents one frame at a time, so peak memory is one
    frame's activations -> (F, H, W, 3) float32. ``tile`` > 0 also tiles each
    frame spatially (``decode_frame_spatially_tiled``); ``tile`` 0 is the
    exact full-frame decode."""
    if tile:
        return torch.stack([decode_frame_spatially_tiled(decoder, latents[i], tile=tile,
                                                         overlap=overlap)
                            for i in range(latents.shape[0])])
    return torch.stack([decoder(latents[i:i + 1])[0] for i in range(latents.shape[0])])
