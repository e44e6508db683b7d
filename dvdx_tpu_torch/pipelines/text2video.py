"""Text -> video latent-diffusion pipeline with Proof-of-Inference recording.

Counterpart of ``dvdx_tpu/pipelines/text2video.py``: encode the
[negative, prompt] pair, draw the base noise from the seed (bit-equal to the
reference's), run the classifier-free-guided DDIM loop, decode frame by
frame. ``generate(..., record=True)`` also returns the per-step (z_t, eps_t)
pairs a miner commits to a Merkle tree (``verify/merkle.py``).

Determinism: given (weights, seed, prompt tokens, schedule, guidance) every
tensor this module produces is a pure function of its inputs on one platform.
On CUDA, ``build_pipeline`` sets the deterministic-algorithm flags
(``dvdx_tpu_torch.enable_determinism``) and every kernel of the path has a
fixed launch shape and no atomics, so a re-executed step reproduces its
leaves bit for bit.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from .. import enable_determinism
from ..models.layers import GroupNorm
from ..models.text_encoder import CLIPTextEncoder, tokenize_batch
from ..models.unet3d import UNet3D
from ..models.vae import VAEDecoder, decode_frames_tiled
from ..models.zoo import ModelSpec, get_model_spec
from ..ops import rng as rng_ops
from ..ops.scheduler import DDIMSchedule, ddim_step, make_ddim_schedule


class Pipeline(nn.Module):
    """The three modules of one model family, on one device."""

    def __init__(self, spec: ModelSpec, unet: UNet3D, text_encoder: CLIPTextEncoder,
                 vae_decoder: VAEDecoder):
        super().__init__()
        self.spec = spec
        self.unet = unet
        self.text_encoder = text_encoder
        self.vae_decoder = vae_decoder

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    def tokenize(self, texts: List[str]) -> np.ndarray:
        """Prompts -> (B, max_length) int32 ids (the hash tokenizer)."""
        return tokenize_batch(texts, self.spec.text.vocab_size,
                              self.spec.text.max_length)


@torch.no_grad()
def random_init(module: nn.Module, seed: int) -> None:
    """Seeded init on the module's device: dense and conv weights
    N(0, 1/fan_in), ``*_zero`` layers and biases 0, norm scales 1,
    embeddings N(0, 1/width), position tables and class tokens N(0, 0.02^2).
    Drawn in float32 from one generator in parameter order, then cast once."""
    dev = next(module.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for mod_name, mod in module.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            if name == "bias" or mod_name.endswith("_zero"):
                p.zero_()
            elif name == "weight" and isinstance(mod, (nn.LayerNorm, GroupNorm)):
                p.fill_(1.0)
            else:
                if name in ("position_embedding", "pos_embedding", "cls_token"):
                    std = 0.02
                elif isinstance(mod, nn.Embedding):
                    std = p.shape[1] ** -0.5
                else:
                    std = (p[0].numel()) ** -0.5
                draw = torch.randn(p.shape, generator=gen, device=dev,
                                   dtype=torch.float32)
                p.copy_(draw * std)


def build_pipeline(model: Union[str, ModelSpec] = "zeroscope-v2-576w",
                   seed: int = 0, device="cuda") -> Pipeline:
    """Seeded random-init pipeline for a registered family (or a spec),
    built on ``device`` with parameters in each module's compute dtype.
    Weights are not the reference's ``fast_init`` draws; parity with the
    reference goes through ``utils.bridge.load_pipeline_params``."""
    device = torch.device(device)
    if device.type == "cuda":
        enable_determinism()
    spec = model if isinstance(model, ModelSpec) else get_model_spec(model)
    with torch.device(device):
        unet = UNet3D(spec.unet).to(spec.unet.compute_dtype)
        text = CLIPTextEncoder(spec.text).to(spec.text.compute_dtype)
        vae = VAEDecoder(spec.vae).to(spec.vae.compute_dtype)
    for i, module in enumerate((unet, text, vae)):
        random_init(module, seed + i)
    pipe = Pipeline(spec, unet, text, vae).eval()
    if device.type == "cuda":
        pipe.to(memory_format=torch.channels_last)  # conv weights, for cuDNN
    return pipe


def encode_prompts(pipe: Pipeline, prompts: List[str]) -> torch.Tensor:
    """Prompts -> encoder hidden states (B, S, hidden)."""
    ids = torch.from_numpy(pipe.tokenize(prompts)).long().to(pipe.device)
    with torch.inference_mode():
        return pipe.text_encoder(ids)[0]


def cfg_denoise_step(unet: UNet3D, sched: DDIMSchedule, z: torch.Tensor,
                     step_index: int, cond: torch.Tensor, uncond: torch.Tensor,
                     guidance_scale: float,
                     cfg_split: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One classifier-free-guided DDIM step -> (z_prev, eps_guided).

    The batched form runs [uncond, cond] as one 2B UNet call; cfg_split runs
    them as two B calls (half the activation memory). The two are different
    step programs, so prover and verifier must agree on the flag. The
    guidance combine runs in eps's dtype."""
    t = int(sched.timesteps[step_index])
    ts = torch.full((z.shape[0],), t, dtype=torch.int32, device=z.device)
    if cfg_split:
        eps_u = unet(z, ts, uncond)
        eps_c = unet(z, ts, cond)
    else:
        eps_u, eps_c = unet(torch.cat([z, z]), torch.cat([ts, ts]),
                            torch.cat([uncond, cond])).chunk(2)
    g = torch.tensor(guidance_scale, dtype=eps_u.dtype, device=eps_u.device)
    eps = eps_u + g * (eps_c - eps_u)
    return ddim_step(sched, step_index, z, eps), eps


def denoise(unet: UNet3D, sched: DDIMSchedule, z0: torch.Tensor,
            cond: torch.Tensor, uncond: torch.Tensor, guidance_scale: float,
            record: bool = False, cfg_split: bool = False):
    """All steps of the schedule from z0 (B, F, h, w, C). With record=True
    also returns zs and epss (steps, B, F, h, w, C): z before each update
    and the guided eps of that step (the Proof-of-Inference leaves)."""
    z, zs, epss = z0, [], []
    for i in range(sched.num_steps):
        z_prev, eps = cfg_denoise_step(unet, sched, z, i, cond, uncond,
                                       guidance_scale, cfg_split=cfg_split)
        if record:
            zs.append(z)
            epss.append(eps)
        z = z_prev
    if record:
        return z, torch.stack(zs), torch.stack(epss)
    return z


def generate_core(pipe: Pipeline, token_ids: torch.Tensor, noise_key: torch.Tensor,
                  *, sched: DDIMSchedule, num_frames: int, height: int, width: int,
                  guidance_scale: float, record: bool = False,
                  latent_dtype: torch.dtype = torch.bfloat16,
                  cfg_split: bool = False):
    """token ids (2, S) [negative, prompt] + noise key -> frames
    (F, H, W, 3) float32 in [-1, 1] [, zs, epss]."""
    spec = pipe.spec
    ds = spec.vae.downscale
    hidden, _ = pipe.text_encoder(token_ids)
    uncond, cond = hidden[0:1], hidden[1:2]
    z0 = rng_ops.video_noise(noise_key, num_frames,
                             (height // ds, width // ds, spec.latent_channels),
                             device=token_ids.device)
    out = denoise(pipe.unet, sched, z0[None].to(latent_dtype), cond, uncond,
                  guidance_scale, record=record, cfg_split=cfg_split)
    z_final = out[0] if record else out
    frames = decode_frames_tiled(pipe.vae_decoder, z_final[0].float())
    return (frames, out[1], out[2]) if record else frames


def generate(pipe: Pipeline, prompt: str, *, negative_prompt: str = "",
             seed: int = 0, num_frames: Optional[int] = None,
             height: Optional[int] = None, width: Optional[int] = None,
             num_steps: Optional[int] = None,
             guidance_scale: Optional[float] = None, record: bool = False,
             cfg_split: bool = False):
    """User-facing generation: uint8 frames (F, H, W, 3) as numpy, plus
    (zs, epss, timesteps) when record=True: zs and epss are bfloat16 CPU
    tensors (steps, 1, F, h, w, C), timesteps int32 numpy."""
    spec = pipe.spec
    num_frames = num_frames or spec.default_frames
    height = height or spec.default_height
    width = width or spec.default_width
    num_steps = num_steps or spec.default_steps
    if guidance_scale is None:
        guidance_scale = spec.default_guidance_scale
    sched = make_ddim_schedule(num_steps, prediction_type=spec.prediction_type)
    ids = torch.from_numpy(pipe.tokenize([negative_prompt, prompt])).long()
    with torch.inference_mode():
        out = generate_core(pipe, ids.to(pipe.device), rng_ops.base_key(seed),
                            sched=sched, num_frames=num_frames, height=height,
                            width=width, guidance_scale=guidance_scale,
                            record=record, cfg_split=cfg_split)
        frames = out[0] if record else out
        video = ((frames + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy()
        if record:
            return video, (out[1].cpu(), out[2].cpu(), sched.timesteps.copy())
    return video
