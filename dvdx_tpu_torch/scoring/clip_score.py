"""CLIP prompt-fidelity scorer.

Counterpart of ``dvdx_tpu/scoring/clip_score.py``: the mean over frames of
the cosine between the prompt's CLIP text embedding and each frame's image
embedding, each cosine clamped below at 0. The frames are resized to the
tower's input with ``jax.image.resize(..., "bilinear")``'s resampling
(``resize_matrix``), the prompt goes through the hash tokenizer (or the
checkpoint's CLIP BPE tokenizer) and the port's ``CLIPTextEncoder``, and
the pooled text state through ``text_proj`` into the shared space. Both
towers run in one batched call on the scorer's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..models.clip_vision import CLIPVisionEncoder, VisionConfig, tiny_vision_config
from ..models.text_encoder import (CLIPTextEncoder, TextEncoderConfig, tiny_text_config,
                                   tokenize_batch)
from ..utils.init import fast_init
from .common import as_device_u8


def resize_matrix(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(in_size, out_size) float32 weights of ``jax.image.resize``'s linear
    method with antialiasing, along one axis: a triangle kernel over the
    sample positions (o + 0.5) * in / out - 0.5, widened by in / out when
    the axis shrinks, each output's weights normalised to sum 1, and zero
    for samples outside the input."""
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.0 - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    w = torch.clamp(1.0 - (x / kernel_scale).abs(), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def resize_bilinear(frames: torch.Tensor, size: int) -> torch.Tensor:
    """(F, H, W, C) float32 -> (F, size, size, C) as jax.image.resize's
    "bilinear" computes it: one product per resized axis (an axis already
    of the target size is left alone)."""
    _, h, w, _ = frames.shape
    if h != size:
        frames = torch.einsum("fhwc,hy->fywc", frames, resize_matrix(h, size, frames.device))
    if w != size:
        frames = torch.einsum("fhwc,wx->fhxc", frames, resize_matrix(w, size, frames.device))
    return frames


CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class CLIPScorer(nn.Module):
    """Shared-projection-space text / image scorer. ``preprocess`` "signed"
    feeds the tower frames in [-1, 1] (the random-init towers' convention),
    "clip" the CLIP mean / std normalisation of pretrained towers
    (``utils.convert.load_clip_scorer``); ``tokenizer`` is the checkpoint's
    CLIP BPE tokenizer, or None for the hash tokenizer."""

    def __init__(self, vision_cfg: VisionConfig, text_cfg: TextEncoderConfig,
                 preprocess: str = "signed", tokenizer=None):
        super().__init__()
        if preprocess not in ("signed", "clip"):
            raise ValueError(f"unknown preprocess {preprocess!r}")
        self.vision_cfg, self.text_cfg = vision_cfg, text_cfg
        self.preprocess, self.tokenizer = preprocess, tokenizer
        self.vision = CLIPVisionEncoder(vision_cfg)
        self.text = CLIPTextEncoder(text_cfg)
        self.text_proj = nn.Parameter(
            torch.zeros(text_cfg.hidden_size, vision_cfg.projection_dim))

    @property
    def device(self) -> torch.device:
        return self.text_proj.device

    def flax_trees(self) -> dict:
        """The reference scorer's ``params`` names: two towers and the bare
        ``text_proj``."""
        return {"vision": self.vision, "text": self.text, "text_proj": self.text_proj}

    @classmethod
    def build(cls, vision_cfg: Optional[VisionConfig] = None,
              text_cfg: Optional[TextEncoderConfig] = None, seed: int = 1234,
              device="cuda") -> "CLIPScorer":
        """Seeded random towers, the reference's draws
        (``utils.init.fast_init`` at seed and seed + 1, float32 not cast),
        and ``text_proj`` drawn as the reference draws it: numpy
        default_rng(seed + 2), N(0, hidden^-1/2)."""
        vision_cfg = vision_cfg or tiny_vision_config()
        text_cfg = text_cfg or tiny_text_config()
        with torch.device(device):
            scorer = cls(vision_cfg, text_cfg)
        scorer.vision.to(vision_cfg.compute_dtype)
        scorer.text.to(text_cfg.compute_dtype)
        fast_init(scorer.vision, seed)
        fast_init(scorer.text, seed + 1)
        proj = np.random.default_rng(seed + 2).normal(
            0, text_cfg.hidden_size ** -0.5,
            (text_cfg.hidden_size, vision_cfg.projection_dim)).astype(np.float32)
        with torch.no_grad():
            scorer.text_proj.copy_(torch.from_numpy(proj))
        return scorer.eval()

    def _ids(self, prompt: str) -> torch.Tensor:
        if self.tokenizer is not None:
            ids = self.tokenizer([prompt], max_length=self.text_cfg.max_length)
        else:
            ids = tokenize_batch([prompt], self.text_cfg.vocab_size,
                                 self.text_cfg.max_length)
        return torch.from_numpy(ids).long().to(self.device)

    @torch.inference_mode()
    def cosines(self, frames_uint8, prompt: str) -> torch.Tensor:
        """Per-frame cosines (F,) float32 on the scorer's device."""
        frames = as_device_u8(frames_uint8, self.device).float() / 127.5 - 1.0
        frames = resize_bilinear(frames, self.vision_cfg.image_size)
        if self.preprocess == "clip":
            mean, std = (torch.tensor(v, device=frames.device) for v in (CLIP_MEAN, CLIP_STD))
            frames = ((frames + 1.0) / 2.0 - mean) / std
        img = self.vision(frames).float()
        _, pooled = self.text(self._ids(prompt))
        txt = pooled.float() @ self.text_proj
        img = img / (img.norm(dim=-1, keepdim=True) + 1e-8)
        txt = txt / (txt.norm(dim=-1, keepdim=True) + 1e-8)
        return (img * txt).sum(dim=-1)

    def score_video(self, frames_uint8, prompt: str) -> float:
        """frames (F, H, W, 3) uint8 (numpy or a tensor) -> [0, 1]."""
        return float(self.cosines(frames_uint8, prompt).clamp(min=0.0).mean())

    def frame_scores(self, frames_uint8, prompt: str) -> np.ndarray:
        return self.cosines(frames_uint8, prompt).cpu().numpy()
