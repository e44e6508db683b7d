"""Model registry, the counterpart of ``dvdx_tpu/models/zoo.py``.

zeroscope-v2-576w and zeroscope-v2-xl share one architecture (the ModelScope
UNet3D) and differ in their native geometry; zeroscope-tiny-hf is the same
block structure at CPU-test scale, and zeroscope-tiny the CPU-test scale of
the rotary temporal style, the mock network's default model. svd-img2vid is
the SVD-class image-to-video family (the zeroscope UNet taking the noise
latent concatenated with the conditioning image's latent, 8 channels in)
and cogvideox-5b the CogVideoX-class video DiT (v-prediction, joint
text-video attention, 16 latent channels); svd-tiny and dit-tiny are their
CPU-test scales.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

from .dit_video import DiTVideoConfig, tiny_dit_config
from .text_encoder import TextEncoderConfig, tiny_text_config
from .unet3d import UNet3DConfig, tiny_hf_unet_config, tiny_unet_config
from .vae import VAEConfig, tiny_vae_config


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    text: TextEncoderConfig
    vae: VAEConfig
    kind: str = "unet3d"                        # unet3d | dit
    unet: Optional[UNet3DConfig] = None
    dit: Optional[DiTVideoConfig] = None
    prediction_type: str = "epsilon"            # epsilon | v_prediction
    conditioning: str = "text"                  # text | image (img2vid)
    default_width: int = 576
    default_height: int = 320
    default_frames: int = 16
    default_steps: int = 25
    default_guidance_scale: float = 7.5

    @property
    def denoiser_config(self) -> Union[UNet3DConfig, DiTVideoConfig]:
        return self.unet if self.kind == "unet3d" else self.dit

    @property
    def latent_channels(self) -> int:
        return self.vae.latent_channels


_FULL_UNET = UNet3DConfig()
_FULL_TEXT = TextEncoderConfig()
_FULL_VAE = VAEConfig()

REGISTRY: Dict[str, ModelSpec] = {
    "zeroscope-tiny": ModelSpec(
        name="zeroscope-tiny", unet=tiny_unet_config(), text=tiny_text_config(),
        vae=tiny_vae_config(), default_width=32, default_height=32,
        default_frames=4, default_steps=4),
    "zeroscope-tiny-hf": ModelSpec(
        name="zeroscope-tiny-hf", unet=tiny_hf_unet_config(),
        text=tiny_text_config(), vae=tiny_vae_config(),
        default_width=32, default_height=32, default_frames=4, default_steps=4),
    "zeroscope-v2-576w": ModelSpec(
        name="zeroscope-v2-576w", unet=_FULL_UNET, text=_FULL_TEXT,
        vae=_FULL_VAE, default_width=576, default_height=320,
        default_frames=16, default_steps=25),
    "zeroscope-v2-xl": ModelSpec(
        name="zeroscope-v2-xl", unet=_FULL_UNET, text=_FULL_TEXT,
        vae=_FULL_VAE, default_width=1024, default_height=576,
        default_frames=24, default_steps=50),
    "svd-tiny": ModelSpec(
        name="svd-tiny",
        unet=dataclasses.replace(tiny_unet_config(), in_channels=8, out_channels=4),
        text=tiny_text_config(), vae=tiny_vae_config(), conditioning="image",
        default_width=32, default_height=32, default_frames=4, default_steps=4,
        default_guidance_scale=3.0),
    "svd-img2vid": ModelSpec(
        name="svd-img2vid",
        unet=dataclasses.replace(_FULL_UNET, in_channels=8, out_channels=4),
        text=_FULL_TEXT, vae=_FULL_VAE, conditioning="image",
        default_width=576, default_height=320, default_frames=25, default_steps=25,
        default_guidance_scale=3.0),
    "dit-tiny": ModelSpec(
        name="dit-tiny", kind="dit", dit=tiny_dit_config(), text=tiny_text_config(),
        vae=tiny_vae_config(), prediction_type="v_prediction",
        default_width=32, default_height=32, default_frames=4, default_steps=4,
        default_guidance_scale=6.0),
    "cogvideox-5b": ModelSpec(
        name="cogvideox-5b", kind="dit",
        dit=DiTVideoConfig(in_channels=16, out_channels=16, hidden_size=3072,
                           num_layers=42, num_heads=48, text_hidden_size=4096),
        text=dataclasses.replace(_FULL_TEXT, hidden_size=4096, intermediate_size=10240,
                                 num_layers=24, num_heads=32, max_length=226),
        vae=dataclasses.replace(_FULL_VAE, latent_channels=16),
        prediction_type="v_prediction",
        default_width=720, default_height=480, default_frames=48,
        default_steps=50, default_guidance_scale=6.0),
}


def get_model_spec(name: str) -> ModelSpec:
    if name not in REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]
