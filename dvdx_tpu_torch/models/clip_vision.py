"""CLIP-style vision transformer of the prompt-fidelity scorer.

Counterpart of ``dvdx_tpu/models/clip_vision.py``: a patch-embedding
convolution (no bias), a class token and learned positions, pre-LN
transformer blocks (GELU with the tanh approximation and LayerNorm eps 1e-6
by default; "quick_gelu" and eps 1e-5 for the OpenAI towers
``utils.convert.load_clip_scorer`` loads) and a bias-free projection of
the class token. Submodule and parameter names follow the reference's flax
tree, so ``utils.bridge`` loads its parameters leaf for leaf. Plain PyTorch throughout: the JAX
package runs the tower on XLA, not on a kernel of its own.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.attention import multi_head_attention
from .layers import Conv, Dense, LayerNorm
from .text_encoder import activation


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    projection_dim: int = 512
    hidden_act: str = "gelu_tanh"
    layer_norm_eps: float = 1e-6
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def tiny_vision_config() -> VisionConfig:
    return VisionConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                        num_heads=4, intermediate_size=128, projection_dim=32)


class _ViTBlock(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.heads = cfg.num_heads
        self.ln1 = LayerNorm(d, eps=eps)
        self.q = Dense(d, d)
        self.k = Dense(d, d)
        self.v = Dense(d, d)
        self.proj = Dense(d, d)
        self.ln2 = LayerNorm(d, eps=eps)
        self.fc1 = Dense(d, cfg.intermediate_size)
        self.fc2 = Dense(cfg.intermediate_size, d)
        self.act = activation(cfg.hidden_act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        h = self.ln1(x)
        q, k, v = (lin(h).view(b, s, self.heads, d // self.heads)
                   for lin in (self.q, self.k, self.v))
        x = x + self.proj(multi_head_attention(q, k, v).reshape(b, s, d))
        return x + self.fc2(self.act(self.fc1(self.ln2(x))))


class CLIPVisionEncoder(nn.Module):
    """images (B, H, W, 3) in [-1, 1] -> projected embedding (B, projection_dim)."""

    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.cfg = cfg
        d, p, eps = cfg.hidden_size, cfg.patch_size, cfg.layer_norm_eps
        self.patch_embed = Conv(3, d, p, stride=p, bias=False)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embedding = nn.Parameter(
            torch.zeros(1, (cfg.image_size // p) ** 2 + 1, d))
        self.pre_ln = LayerNorm(d, eps=eps)
        for i in range(cfg.num_layers):
            self.add_module(f"layer{i}", _ViTBlock(cfg))
        self.post_ln = LayerNorm(d, eps=eps)
        self.visual_projection = Dense(d, cfg.projection_dim, bias=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dt = self.patch_embed.weight.dtype
        b, d = images.shape[0], self.cfg.hidden_size
        x = self.patch_embed(images.to(dt)).reshape(b, -1, d)
        x = torch.cat([self.cls_token.to(dt).expand(b, 1, d), x], dim=1)
        x = self.pre_ln(x + self.pos_embedding.to(dt))
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layer{i}")(x)
        return self.visual_projection(self.post_ln(x[:, 0]))
