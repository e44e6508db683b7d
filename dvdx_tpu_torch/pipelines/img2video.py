"""Image -> video pipeline (the SVD-class img2vid family).

Counterpart of ``dvdx_tpu/pipelines/img2video.py``: the conditioning image is
VAE-encoded, its latent (plus ``cond_aug`` times an auxiliary noise stream of
the seed) is concatenated to every frame's noise latent on the channel axis
(the UNet takes 2 x latent_channels), and the latent's spatial mean, zero
padded to the cross-attention width, is the one-token conditioning context,
with an all-zero context as the unconditional branch. The denoise loop, its
Proof-of-Inference recording and the per-frame decode are text2video's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..models.vae import VAEEncoder, decode_frames_tiled
from ..ops import rng as rng_ops
from ..utils.bridge import load_tree
from ..utils.init import fast_init
from .text2video import Pipeline, build_pipeline, denoise, to_uint8

AUX_TAG_COND_AUG = 7  # the aux_noise tag of the conditioning augmentation


class Img2VideoPipeline(nn.Module):
    """A text2video ``Pipeline`` of an image-conditioned family and its VAE
    encoder, on one device."""

    def __init__(self, base: Pipeline, vae_encoder: VAEEncoder):
        super().__init__()
        self.base = base
        self.vae_encoder = vae_encoder

    @property
    def spec(self):
        return self.base.spec

    @property
    def device(self) -> torch.device:
        return self.base.device

    def flax_trees(self) -> dict:
        """The reference's img2vid ``Pipeline.params`` names of the modules."""
        return {**self.base.flax_trees(), "vae_enc": self.vae_encoder}


def build_img2video_pipeline(model_name: str = "svd-tiny", seed: int = 0,
                             device="cuda") -> Img2VideoPipeline:
    """Seeded random-init img2vid pipeline on ``device``: ``build_pipeline``'s
    three modules (seeds seed .. seed + 2) and the VAE encoder (seed + 3),
    the reference's draws (``utils.init.fast_init``; the reference keeps
    the encoder's leaves in float32, the port rounds them once into the
    encoder's compute dtype, so the two are bit-equal where that is
    float32, as in svd-tiny)."""
    base = build_pipeline(model_name, seed=seed, device=device)
    if base.spec.conditioning != "image":
        raise ValueError(f"{model_name} is not an image-conditioned family")
    vae = base.spec.vae
    enc = VAEEncoder(vae).to(device=base.device, dtype=vae.compute_dtype)
    if base.device.type == "cuda":
        enc.to(memory_format=torch.channels_last)
    fast_init(enc, seed + 3)
    return Img2VideoPipeline(base, enc.eval())


def load_img2video_params(pipe: Img2VideoPipeline, tree) -> Img2VideoPipeline:
    """The reference's img2vid ``Pipeline.params`` ({'unet', 'text',
    'vae_dec', 'vae_enc'}) into ``pipe``'s four modules; a tree without
    'vae_enc' raises KeyError."""
    return load_tree(pipe, tree)


def conditioning(pipe: Img2VideoPipeline, image: torch.Tensor, noise_key: torch.Tensor,
                 cond_aug: float):
    """(H, W, 3) float32 image in [-1, 1] on the pipeline's device ->
    (conditioning latent (h, w, C) float32 with its augmentation, context
    (1, 1, width), unconditional context (1, 1, width))."""
    spec = pipe.spec
    cond_lat = pipe.vae_encoder(image[None])[0]
    cond_lat = cond_lat + cond_aug * rng_ops.aux_noise(noise_key, cond_lat,
                                                       AUX_TAG_COND_AUG)
    c = cond_lat.shape[-1]
    width = (spec.unet.cross_attention_dim if spec.kind == "unet3d"
             else spec.dit.text_hidden_size)
    ctx = torch.zeros((1, 1, width), dtype=cond_lat.dtype, device=cond_lat.device)
    ctx[..., :c] = cond_lat.reshape(1, -1, c).mean(dim=1, keepdim=True)
    return cond_lat, ctx, torch.zeros_like(ctx)


def generate_from_image(pipe: Img2VideoPipeline, image: np.ndarray, *, seed: int = 0,
                        num_frames: Optional[int] = None,
                        num_steps: Optional[int] = None,
                        guidance_scale: Optional[float] = None,
                        cond_aug: float = 0.02, record: bool = False):
    """uint8 (H, W, 3) conditioning frame -> uint8 (F, H, W, 3) numpy video,
    plus (zs, epss, timesteps) when record=True, as ``text2video.generate``
    returns them (zs and epss bfloat16 CPU tensors (steps, 1, F, h, w, C))."""
    base = pipe.base
    spec = base.spec
    num_frames = num_frames or spec.default_frames
    num_steps = num_steps or spec.default_steps
    if guidance_scale is None:
        guidance_scale = spec.default_guidance_scale
    ds = spec.vae.downscale
    lh, lw = image.shape[0] // ds, image.shape[1] // ds
    sched = spec.ddim_schedule(num_steps)
    key = rng_ops.base_key(seed)
    with torch.inference_mode():
        img = torch.from_numpy(np.ascontiguousarray(image)).to(pipe.device).float()
        cond_lat, ctx, uncond = conditioning(pipe, img / 127.5 - 1.0, key, cond_aug)
        z0 = rng_ops.video_noise(key, num_frames, (lh, lw, spec.latent_channels),
                                 device=pipe.device)[None].bfloat16()

        def unet_concat(x, ts, context, frame_positions=None):
            cp = cond_lat.to(x.dtype).expand((x.shape[0], num_frames) + cond_lat.shape)
            return base.unet(torch.cat([x, cp], dim=-1), ts, context, frame_positions)

        out = denoise(unet_concat, sched, z0, ctx, uncond, guidance_scale, record=record)
        z = out[0] if record else out
        video = to_uint8(decode_frames_tiled(base.vae_decoder, z[0].float())).cpu().numpy()
        if record:
            return video, (out[1].cpu(), out[2].cpu(), sched.timesteps.copy())
    return video
