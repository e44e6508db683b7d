"""Zeroscope-class conditional UNet3D.

Counterpart of ``dvdx_tpu/models/unet3d.py``: per-frame resnets and spatial
transformers with text cross-attention, temporal convolutions and temporal
mixers at every level, a sinusoidal time embedding, and ``transformer_in``
after ``conv_in``. Two temporal styles, as in the reference:
``'diffusers'`` (TransformerTemporalModel: GroupNorm, proj_in / out, GEGLU,
no positions; ``transformer_in`` has 8 heads of C0 / 8) and ``'rotary'``
(``layers.TemporalAttention``: LayerNorm, rotary frame positions, no FF;
``transformer_in`` has C0 / head_dim heads), the style of
``zeroscope-tiny``. Spatial ops fold frames into the batch (batch-major,
row b * F + f); the layout is channel-last throughout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from .layers import (Conv, Downsample2D, GroupNorm, ResnetBlock2D,
                     SpatialTransformer, TemporalAttention, TemporalConvBlock,
                     TimeEmbedding, TransformerTemporal, Upsample2D,
                     timestep_embedding)
from ..utils.profiling import span


@dataclasses.dataclass(frozen=True)
class UNet3DConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_levels: Tuple[bool, ...] = (True, True, True, False)
    attention_head_dim: int = 64
    cross_attention_dim: int = 1024
    norm_groups: int = 32
    norm_eps: float = 1e-5
    temporal_conv_layers: int = 4
    use_rotary_time: bool = True
    temporal_style: str = "diffusers"  # or "rotary"
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def tiny_unet_config() -> UNet3DConfig:
    """CPU-test scale in the rotary temporal style (``zeroscope-tiny``, the
    mock network's default model)."""
    return UNet3DConfig(block_out_channels=(32, 64), layers_per_block=1,
                        cross_attention_levels=(True, False),
                        attention_head_dim=16, cross_attention_dim=64,
                        norm_groups=8, temporal_conv_layers=1,
                        temporal_style="rotary", dtype="float32")


def _temporal_mixer(cfg: UNet3DConfig, channels: int, heads: int,
                    head_dim: int) -> nn.Module:
    """The configured style's temporal mixer over (B, F, H, W, C)."""
    if cfg.temporal_style == "diffusers":
        return TransformerTemporal(channels, heads, head_dim, cfg.norm_groups)
    if cfg.temporal_style == "rotary":
        return TemporalAttention(channels, heads, head_dim, cfg.use_rotary_time)
    raise ValueError(f"unknown temporal_style {cfg.temporal_style!r}")


def tiny_hf_unet_config() -> UNet3DConfig:
    """CPU-test scale, same block semantics as the full zeroscope specs."""
    return UNet3DConfig(block_out_channels=(32, 64), layers_per_block=1,
                        cross_attention_levels=(True, False),
                        attention_head_dim=16, cross_attention_dim=64,
                        norm_groups=8, temporal_conv_layers=4, dtype="float32")


class _LevelBlock(nn.Module):
    """resnet, temporal conv, then (spatial transformer, temporal
    transformer) where the level has attention."""

    def __init__(self, cfg: UNet3DConfig, in_channels: int, out_channels: int,
                 has_attention: bool):
        super().__init__()
        temb_dim = cfg.block_out_channels[0] * 4
        g = cfg.norm_groups
        self.resnet = ResnetBlock2D(in_channels, out_channels, temb_dim, g,
                                    cfg.norm_eps)
        self.temp_conv = TemporalConvBlock(out_channels, cfg.temporal_conv_layers,
                                           g, cfg.norm_eps)
        self.has_attention = has_attention
        if has_attention:
            heads = max(1, out_channels // cfg.attention_head_dim)
            self.spatial_attn = SpatialTransformer(
                out_channels, heads, cfg.attention_head_dim,
                cfg.cross_attention_dim, g)
            self.temporal_attn = _temporal_mixer(cfg, out_channels, heads,
                                                 cfg.attention_head_dim)

    def forward(self, x, temb_pf, context_pf, frame_positions=None):
        b, f = x.shape[:2]
        x = self.resnet(x.flatten(0, 1), temb_pf).unflatten(0, (b, f))
        x = self.temp_conv(x)
        if self.has_attention:
            x = self.spatial_attn(x.flatten(0, 1), context_pf).unflatten(0, (b, f))
            x = self.temporal_attn(x, frame_positions)
        return x


class UNet3D(nn.Module):
    """eps prediction. latents (B, F, H, W, in_channels), timesteps (B,)
    int, encoder_hidden_states (B, T, cross_attention_dim), and for the
    rotary style optional absolute frame_positions (F,) -> latents' shape
    and dtype."""

    def __init__(self, cfg: UNet3DConfig):
        super().__init__()
        self.cfg = cfg
        chs = cfg.block_out_channels
        ch0, levels, lpb = chs[0], len(chs), cfg.layers_per_block
        self.conv_in = Conv(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimeEmbedding(ch0, ch0 * 4)
        # transformer_in's heads: 8 of C0 / 8 in the diffusers style, the
        # blocks' head width in the rotary style (as the reference builds it)
        if cfg.temporal_style == "diffusers":
            in_heads, in_head_dim = 8, max(1, ch0 // 8)
        else:
            in_heads, in_head_dim = max(1, ch0 // cfg.attention_head_dim), cfg.attention_head_dim
        self.transformer_in = _temporal_mixer(cfg, ch0, in_heads, in_head_dim)
        cur, skips = ch0, [ch0]
        for level, out_ch in enumerate(chs):
            for blk in range(lpb):
                self.add_module(f"down_{level}_{blk}", _LevelBlock(
                    cfg, cur, out_ch, cfg.cross_attention_levels[level]))
                cur = out_ch
                skips.append(cur)
            if level < levels - 1:
                self.add_module(f"down_{level}_downsample", Downsample2D(cur))
                skips.append(cur)
        self.mid_0 = _LevelBlock(cfg, cur, chs[-1], True)
        self.mid_1 = _LevelBlock(cfg, chs[-1], chs[-1], False)
        cur = chs[-1]
        for level in reversed(range(levels)):
            out_ch = chs[level]
            for blk in range(lpb + 1):
                self.add_module(f"up_{level}_{blk}", _LevelBlock(
                    cfg, cur + skips.pop(), out_ch,
                    cfg.cross_attention_levels[level]))
                cur = out_ch
            if level > 0:
                self.add_module(f"up_{level}_upsample", Upsample2D(cur))
        self.conv_norm_out = GroupNorm(ch0, cfg.norm_groups, cfg.norm_eps,
                                       act="silu")
        self._down_spans = tuple(f"unet.down{level}" for level in range(levels))
        self._up_spans = tuple(f"unet.up{level}" for level in range(levels))
        self.conv_out_zero = Conv(ch0, cfg.out_channels, 3, padding=1)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                frame_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        dt = self.conv_in.weight.dtype
        b, f = latents.shape[:2]
        chs, levels = cfg.block_out_channels, len(cfg.block_out_channels)
        temb = self.time_embedding(timestep_embedding(timesteps, chs[0]))
        temb_pf = temb.repeat_interleave(f, dim=0)
        context_pf = encoder_hidden_states.to(dt).repeat_interleave(f, dim=0)

        x = self.conv_in(latents.to(dt).flatten(0, 1)).unflatten(0, (b, f))
        x = self.transformer_in(x, frame_positions)
        skips = [x]
        for level in range(levels):
            with span(self._down_spans[level]):
                for blk in range(cfg.layers_per_block):
                    x = getattr(self, f"down_{level}_{blk}")(x, temb_pf, context_pf,
                                                             frame_positions)
                    skips.append(x)
                if level < levels - 1:
                    x = getattr(self, f"down_{level}_downsample")(
                        x.flatten(0, 1)).unflatten(0, (b, f))
                    skips.append(x)
        with span("unet.mid"):
            x = self.mid_0(x, temb_pf, context_pf, frame_positions)
            x = self.mid_1(x, temb_pf, context_pf, frame_positions)
        for level in reversed(range(levels)):
            with span(self._up_spans[level]):
                for blk in range(cfg.layers_per_block + 1):
                    x = torch.cat([x, skips.pop()], dim=-1)
                    x = getattr(self, f"up_{level}_{blk}")(x, temb_pf, context_pf,
                                                           frame_positions)
                if level > 0:
                    x = getattr(self, f"up_{level}_upsample")(
                        x.flatten(0, 1)).unflatten(0, (b, f))
        xs = self.conv_out_zero(self.conv_norm_out(x.flatten(0, 1)))
        return xs.unflatten(0, (b, f)).to(latents.dtype)
