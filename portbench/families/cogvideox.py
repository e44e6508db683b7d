"""The cogvideox family: the published CogVideoX-5B transformer (diffusers'
``CogVideoXTransformer3DModel``) over a T5 v1.1 XXL encoder (transformers'
``T5EncoderModel``), sampled by v-prediction DDIM with zero-terminal-SNR
alpha-bar and trailing spacing, with classifier-free guidance; decoded by
an AutoencoderKL decoder at the published VAE's widths, one frame a latent
frame. The port serves it as ``models.cogvideox``, ``models.t5`` and
``models.vae``.

The seeded draw scales each tensor as a checkpoint's would be spread: a
matrix or convolution kernel N(0, 1 / fan_in) (the VAE's last convolution
at half that spread, so that few decoded pixels clip); a norm's scale 1 +
N(0, 0.05^2); a norm's shift and every bias N(0, 0.05^2); the T5 token
table and its relative-position bias N(0, 1). T5 scales no attention score:
its query projection carries the 1 / sqrt(d_kv) instead (its published
initialisation, N(0, 1 / (d_model d_kv))), and so does the draw here; at
N(0, 1 / d_model) the scores' spread is 8x a scaled attention's, the
softmax nearly one-hot, and the bf16 tower's states part from the float32
reference's by tens of percent with any weights.

The program's latents are channel-last, (batch, frames, h, w, channels);
the reference's transformer takes diffusers' (batch, frames, channels, h,
w).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from ..costs import count_flops
from ..reference import noise as ref_noise
from ..reference.clip_text import tokenize
from ..reference.cogvideox import (CogVideoXDDIMSchedulerRef, CogVideoXTransformer3DRef,
                                   JointAttention, T5Attention, T5EncoderRef)
from ..reference.torch_ref import AutoencoderKLRef, VAEAttention

COMPONENTS = ("transformer", "vae", "text")
NORM_SPREAD = 0.05
BIAS_SPREAD = 0.05
VAE_OUT_GAIN = 0.5
TABLES = ("shared.weight", "relative_attention_bias.weight")
T5_QUERY = "SelfAttention.q.weight"


def reference_modules(cfg: dict) -> Dict[str, torch.nn.Module]:
    """The reference's towers hold their linear weights in the draw's dtype
    (exact) and compute in float32."""
    t, v = cfg["transformer"], cfg["vae"]
    wd = getattr(torch, cfg["dtype"])
    transformer = CogVideoXTransformer3DRef(
        num_attention_heads=t["num_attention_heads"], attention_head_dim=t["attention_head_dim"],
        in_channels=t["in_channels"], out_channels=t["out_channels"],
        time_embed_dim=t["time_embed_dim"], text_embed_dim=t["text_embed_dim"],
        num_layers=t["num_layers"], sample_width=t["sample_width"],
        sample_height=t["sample_height"], patch_size=t["patch_size"], norm_eps=t["norm_eps"],
        weight_dtype=wd)
    vae = AutoencoderKLRef(
        latent_ch=v["latent_channels"], block_out_channels=tuple(v["block_out_channels"]),
        layers_per_block=v["layers_per_block"], groups=v["norm_num_groups"], mid_attention=False)
    del vae.encoder, vae.quant_conv  # the decoder alone is served
    return {"transformer": transformer, "vae": vae, "text": T5EncoderRef(cfg["text"], wd)}


def spread(component: str, key: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    if component == "text" and key.endswith(TABLES):
        return 1.0, 0.0
    if component == "text" and key.endswith(T5_QUERY):
        d_kv = 64  # T5 v1.1 XXL's head width: the draw sees only shapes
        return 1.0 / math.sqrt(shape[1] * d_kv), 0.0
    if len(shape) >= 2:
        gain = VAE_OUT_GAIN if (component, key) == ("vae", "decoder.conv_out.weight") else 1.0
        return gain / math.sqrt(math.prod(shape[1:])), 0.0
    if key.endswith(".weight"):  # a one-dimensional weight is a norm's scale
        return NORM_SPREAD, 1.0
    return BIAS_SPREAD, 0.0


# -- the program's side --

def port_spec(cfg: dict):
    """The port's ``ModelSpec`` of a configuration file, through the port's
    own reading of a CogVideoX checkpoint's config.json files."""
    from dvdx_tpu_torch.utils.convert import cogvideox_spec

    g = cfg["geometry"]
    spec = cogvideox_spec(cfg["transformer"], cfg["text"], cfg["vae"], cfg["name"],
                          cfg["dtype"])
    return dataclasses.replace(spec, default_width=g["width"], default_height=g["height"],
                               default_frames=g["num_frames"], default_steps=g["num_steps"],
                               default_guidance_scale=g["guidance_scale"])


def empty_pipeline(cfg: dict, device):
    from dvdx_tpu_torch.pipelines.text2video import empty_pipeline as empty

    return empty(port_spec(cfg), device)


def load(pipe, cfg: dict, component: str, sd: dict) -> None:
    from dvdx_tpu_torch.utils.bridge import load_jax_params
    from dvdx_tpu_torch.utils.convert import (convert_cogvideox_transformer, convert_t5_encoder,
                                              convert_vae_decoder)

    spec = port_spec(cfg)
    module, convert = {
        "transformer": (pipe.unet, lambda: convert_cogvideox_transformer(sd, spec.dit)),
        "vae": (pipe.vae_decoder, lambda: convert_vae_decoder(sd, spec.vae)),
        "text": (pipe.text_encoder, lambda: convert_t5_encoder(sd, spec.text))}[component]
    load_jax_params(module, convert())


# -- the reference's side, at the program's inputs --

def _text_len(cfg: dict) -> int:
    return cfg["transformer"]["max_text_seq_length"]


def text_states(ref, request: dict, cfg: dict, device):
    ids = torch.from_numpy(tokenize([request["negative_prompt"], request["prompt"]],
                                    cfg["text"]["vocab_size"], _text_len(cfg)))
    return ids, ref.text(ids.to(device)).float()


def _downsampling(cfg: dict) -> int:
    return 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)


def base_latent(request: dict, cfg: dict) -> torch.Tensor:
    ds = _downsampling(cfg)
    shape = (request["height"] // ds, request["width"] // ds, cfg["vae"]["latent_channels"])
    return torch.from_numpy(ref_noise.video_noise(request["seed"], request["num_frames"],
                                                  shape))


def denoise(ref, z: torch.Tensor, t: int, hidden: torch.Tensor, device) -> torch.Tensor:
    """z (1, F, h, w, C) channel-last -> the transformer's v, channel-last."""
    x = z.permute(0, 1, 4, 2, 3).to(device)
    out = ref.transformer(x, hidden.to(device), torch.tensor([t], device=device))
    return out.permute(0, 1, 3, 4, 2).float().cpu()


def update(num_steps: int, t: int, z: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    sched = CogVideoXDDIMSchedulerRef()
    sched.set_timesteps(num_steps)
    return sched.step(eps, t, z)


def decode(ref, z_in: torch.Tensor, cfg: dict, device) -> torch.Tensor:
    """The decoder's input as the program hands it (scaled latent frames,
    channel-last) -> RGB frames, channel-last."""
    x = (z_in / cfg["vae"]["scaling_factor"]).permute(0, 3, 1, 2).to(device)
    return ref.vae.decode(x).permute(0, 2, 3, 1).float().cpu()


# -- the yardstick's counts --

def _latent_shape(cfg: dict):
    g = cfg["geometry"]
    ds = _downsampling(cfg)
    return g["num_frames"], g["height"] // ds, g["width"] // ds, cfg["vae"]["latent_channels"]


def bound_calls(pipe, cfg: dict, device) -> dict:
    """One transformer call (both guidance rows) and one decoded frame at
    the cell's shapes."""
    f, h, w, c = _latent_shape(cfg)
    b = 1 if cfg["geometry"]["cfg_split"] else 2
    dt = getattr(torch, cfg["dtype"])
    z = torch.randn(b, f, h, w, c, device=device).to(dt)
    ts = torch.full((b,), 500, dtype=torch.int32, device=device)
    ctx = torch.randn(b, _text_len(cfg), cfg["transformer"]["text_embed_dim"],
                      device=device).to(dt)
    return {"unet": (pipe.unet, lambda: pipe.unet(z, ts, ctx)),
            "frames": (pipe.vae_decoder, lambda: pipe.vae_decoder(z[0, :1].float()))}


def _joint_attn_flops(mod, args, kwargs) -> float:
    h, enc = args[0], args[1]
    s = h.shape[1] + enc.shape[1]
    return 4.0 * h.shape[0] * s * s * mod.to_q.out_features


def _t5_attn_flops(mod, args, kwargs) -> float:
    b, s, _ = args[0].shape
    return 4.0 * b * s * s * mod.q.out_features


def _vae_attn_flops(mod, args, kwargs) -> float:
    b, ch, hh, ww = args[0].shape
    return 4.0 * b * (hh * ww) ** 2 * ch


# Q K^T and P V of each of the reference's attention modules
ATTENTION = ((JointAttention, _joint_attn_flops), (T5Attention, _t5_attn_flops),
             (VAEAttention, _vae_attn_flops))


def model_flops(cfg: dict) -> dict:
    """Model FLOPs of one transformer row (one sample of a call: every
    projection and each block's 4 S^2 x hidden of attention over the S
    joint tokens), one text encode row and one decoded frame at the
    configuration's geometry, counted on the plain reference's modules on
    the meta device."""
    f, h, w, c = _latent_shape(cfg)
    n = _text_len(cfg)
    with torch.device("meta"):
        m = reference_modules(cfg)
        ctx = torch.zeros(1, n, cfg["transformer"]["text_embed_dim"])
        return {
            "unet_rows": count_flops(m["transformer"], lambda: m["transformer"](
                torch.zeros(1, f, c, h, w), ctx, torch.zeros(1)), ATTENTION),
            "text_rows": count_flops(m["text"], lambda: m["text"](
                torch.zeros(1, n, dtype=torch.long)), ATTENTION),
            "frames": count_flops(m["vae"], lambda: m["vae"].decode(torch.zeros(1, c, h, w)),
                                  ATTENTION),
        }
