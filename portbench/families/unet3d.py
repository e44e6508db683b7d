"""The zeroscope family: a UNet3D denoiser (diffusers' UNet3DConditionModel
layout), the AutoencoderKL decoder and a CLIP text tower, sampled by DDIM
with classifier-free guidance; the port serves it as ``models.unet3d``,
``models.vae`` and ``models.text_encoder``.

The seeded draw scales each tensor of the three state dicts as a
checkpoint's would be spread: a matrix or convolution kernel N(0, 1 /
fan_in) (the VAE's last convolution at half that spread, so that few
decoded pixels clip); a norm's scale 1 + N(0, 0.05^2); a norm's shift and
every bias N(0, 0.05^2); an embedding table N(0, 1).

The program's latents are channel-last, (batch, frames, h, w, channels);
the reference's are diffusers' (batch, channels, frames, h, w).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..costs import count_flops
from ..reference import noise as ref_noise
from ..reference.clip_text import CLIPTextRef, _SelfAttention, tokenize
from ..reference.torch_ref import (Attention, AutoencoderKLRef, DDIMSchedulerRef,
                                   UNet3DConditionModelRef, VAEAttention)

COMPONENTS = ("unet", "vae", "text")
NORM_SPREAD = 0.05
BIAS_SPREAD = 0.05
VAE_OUT_GAIN = 0.5


def reference_modules(cfg: dict) -> Dict[str, torch.nn.Module]:
    u, v, t = cfg["unet"], cfg["vae"], cfg["text"]
    unet = UNet3DConditionModelRef(
        in_channels=u["in_channels"], out_channels=u["out_channels"],
        block_out_channels=tuple(u["block_out_channels"]),
        layers_per_block=u["layers_per_block"],
        cross_levels=tuple(u["cross_attention_levels"]), head_dim=u["attention_head_dim"],
        cross_dim=u["cross_attention_dim"], groups=u["norm_groups"],
        n_temp_convs=u["temporal_conv_layers"])
    vae = AutoencoderKLRef(
        latent_ch=v["latent_channels"],
        block_out_channels=tuple(v["base_channels"] * m for m in v["channel_mults"]),
        layers_per_block=v["layers_per_block"], groups=v["norm_groups"],
        mid_attention=v["use_mid_attention"])
    del vae.encoder, vae.quant_conv  # the decoder alone is served
    text = CLIPTextRef(t["vocab_size"], t["hidden_size"], t["num_layers"], t["num_heads"],
                       t["intermediate_size"], t["max_length"], t["layer_norm_eps"])
    return {"unet": unet, "vae": vae, "text": text}


def spread(component: str, key: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    if key.endswith("embedding.weight"):
        return 1.0, 0.0
    if len(shape) >= 2:
        gain = VAE_OUT_GAIN if (component, key) == ("vae", "decoder.conv_out.weight") else 1.0
        return gain / math.sqrt(math.prod(shape[1:])), 0.0
    if key.endswith(".weight"):  # a one-dimensional weight is a norm's scale
        return NORM_SPREAD, 1.0
    return BIAS_SPREAD, 0.0


# -- the program's side --

def port_spec(cfg: dict):
    """The port's ``ModelSpec`` of a configuration file, on the port's own
    config classes (the zoo's for the zeroscope configurations)."""
    from dvdx_tpu_torch.models.text_encoder import TextEncoderConfig
    from dvdx_tpu_torch.models.unet3d import UNet3DConfig
    from dvdx_tpu_torch.models.vae import VAEConfig
    from dvdx_tpu_torch.models.zoo import ModelSpec

    dt = cfg["dtype"]
    u = dict(cfg["unet"], temporal_style="diffusers", dtype=dt)
    u["block_out_channels"] = tuple(u["block_out_channels"])
    u["cross_attention_levels"] = tuple(u["cross_attention_levels"])
    v = dict(cfg["vae"], channel_mults=tuple(cfg["vae"]["channel_mults"]), final_tanh=False,
             dtype=dt)
    g = cfg["geometry"]
    return ModelSpec(name=cfg["name"], unet=UNet3DConfig(**u),
                     text=TextEncoderConfig(**cfg["text"], dtype=dt), vae=VAEConfig(**v),
                     default_width=g["width"], default_height=g["height"],
                     default_frames=g["num_frames"], default_steps=g["num_steps"],
                     default_guidance_scale=g["guidance_scale"])


def empty_pipeline(cfg: dict, device):
    from dvdx_tpu_torch.pipelines.text2video import empty_pipeline as empty

    return empty(port_spec(cfg), device)


def load(pipe, cfg: dict, component: str, sd: dict) -> None:
    from dvdx_tpu_torch.utils.bridge import load_jax_params
    from dvdx_tpu_torch.utils.convert import (convert_text_encoder, convert_unet3d,
                                              convert_vae_decoder)

    spec = port_spec(cfg)
    module, convert = {"unet": (pipe.unet, lambda: convert_unet3d(sd, spec.unet)),
                       "vae": (pipe.vae_decoder, lambda: convert_vae_decoder(sd, spec.vae)),
                       "text": (pipe.text_encoder,
                                lambda: convert_text_encoder(sd, spec.text))}[component]
    load_jax_params(module, convert())


# -- the reference's side, at the program's inputs --

def text_states(ref, request: dict, cfg: dict, device):
    t = cfg["text"]
    ids = torch.from_numpy(tokenize([request["negative_prompt"], request["prompt"]],
                                    t["vocab_size"], t["max_length"]))
    return ids, ref.text(ids.to(device)).float()


def _downsampling(cfg: dict) -> int:
    return 2 ** (len(cfg["vae"]["channel_mults"]) - 1)


def base_latent(request: dict, cfg: dict) -> torch.Tensor:
    ds = _downsampling(cfg)
    shape = (request["height"] // ds, request["width"] // ds, cfg["vae"]["latent_channels"])
    return torch.from_numpy(ref_noise.video_noise(request["seed"], request["num_frames"],
                                                  shape))


def denoise(ref, z: torch.Tensor, t: int, hidden: torch.Tensor, device) -> torch.Tensor:
    """z (1, F, h, w, C) channel-last -> the UNet's output, channel-last."""
    x = z.permute(0, 4, 1, 2, 3).to(device)
    out = ref.unet(x, torch.tensor([t], device=device), hidden.to(device))
    return out.permute(0, 2, 3, 4, 1).float().cpu()


def update(num_steps: int, t: int, z: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    sched = DDIMSchedulerRef()
    sched.set_timesteps(num_steps)
    return sched.step(eps, t, z)


def decode(ref, z_in: torch.Tensor, cfg: dict, device) -> torch.Tensor:
    """The decoder's input as the program hands it (scaled latent frames,
    channel-last) -> RGB frames, channel-last."""
    x = (z_in / cfg["vae"]["scaling_factor"]).permute(0, 3, 1, 2).to(device)
    return ref.vae.decode(x).permute(0, 2, 3, 1).float().cpu()


# -- the yardstick's counts --

def bound_calls(pipe, cfg: dict, device) -> dict:
    """One UNet call and one decoded frame at the cell's shapes."""
    g, v = cfg["geometry"], cfg["vae"]
    ds = _downsampling(cfg)
    f, h, w, c = g["num_frames"], g["height"] // ds, g["width"] // ds, v["latent_channels"]
    b = 1 if g["cfg_split"] else 2
    dt = getattr(torch, cfg["dtype"])
    z = torch.randn(b, f, h, w, c, device=device).to(dt)
    ts = torch.full((b,), 500, dtype=torch.int32, device=device)
    ctx = torch.randn(b, cfg["text"]["max_length"], cfg["unet"]["cross_attention_dim"],
                      device=device).to(dt)
    return {"unet": (pipe.unet, lambda: pipe.unet(z, ts, ctx)),
            "frames": (pipe.vae_decoder, lambda: pipe.vae_decoder(z[0, :1].float()))}


def _attn_flops(mod, args, kwargs) -> float:
    x = args[0]
    ctx = kwargs.get("context", args[1] if len(args) > 1 else None)
    sk = x.shape[1] if ctx is None else ctx.shape[1]
    return 4.0 * x.shape[0] * x.shape[1] * sk * mod.heads * mod.dim_head


def _vae_attn_flops(mod, args, kwargs) -> float:
    b, ch, hh, ww = args[0].shape
    return 4.0 * b * (hh * ww) ** 2 * ch


def _text_attn_flops(mod, args, kwargs) -> float:
    b, s, d = args[0].shape
    return 4.0 * b * s * s * d


# Q K^T and P V of each of the reference's attention modules
ATTENTION = ((Attention, _attn_flops), (VAEAttention, _vae_attn_flops),
             (_SelfAttention, _text_attn_flops))


def model_flops(cfg: dict) -> dict:
    """Model FLOPs of one UNet row (one sample of a UNet call), one text
    encode row and one decoded frame at the configuration's geometry,
    counted on the plain reference's modules on the meta device."""
    g, v, t = cfg["geometry"], cfg["vae"], cfg["text"]
    ds = _downsampling(cfg)
    f, h, w, c = g["num_frames"], g["height"] // ds, g["width"] // ds, v["latent_channels"]
    with torch.device("meta"):
        m = reference_modules(cfg)
        ctx = torch.zeros(1, t["max_length"], cfg["unet"]["cross_attention_dim"])
        return {
            "unet_rows": count_flops(m["unet"], lambda: m["unet"](
                torch.zeros(1, c, f, h, w), torch.zeros(1), ctx), ATTENTION),
            "text_rows": count_flops(m["text"], lambda: m["text"](
                torch.zeros(1, t["max_length"], dtype=torch.long)), ATTENTION),
            "frames": count_flops(m["vae"], lambda: m["vae"].decode(torch.zeros(1, c, h, w)),
                                  ATTENTION),
        }
