"""Model registry: the zeroscope family of ``dvdx_tpu/models/zoo.py``.

zeroscope-v2-576w and zeroscope-v2-xl share one architecture (the ModelScope
UNet3D) and differ in their native geometry; zeroscope-tiny-hf is the same
block structure at CPU-test scale, and zeroscope-tiny the CPU-test scale of
the rotary temporal style, the mock network's default model.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from .text_encoder import TextEncoderConfig, tiny_text_config
from .unet3d import UNet3DConfig, tiny_hf_unet_config, tiny_unet_config
from .vae import VAEConfig, tiny_vae_config


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    unet: UNet3DConfig
    text: TextEncoderConfig
    vae: VAEConfig
    prediction_type: str = "epsilon"
    default_width: int = 576
    default_height: int = 320
    default_frames: int = 16
    default_steps: int = 25
    default_guidance_scale: float = 7.5

    @property
    def latent_channels(self) -> int:
        return self.vae.latent_channels


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
        name="zeroscope-v2-576w", unet=UNet3DConfig(), text=TextEncoderConfig(),
        vae=VAEConfig(), default_width=576, default_height=320,
        default_frames=16, default_steps=25),
    "zeroscope-v2-xl": ModelSpec(
        name="zeroscope-v2-xl", unet=UNet3DConfig(), text=TextEncoderConfig(),
        vae=VAEConfig(), default_width=1024, default_height=576,
        default_frames=24, default_steps=50),
}


def get_model_spec(name: str) -> ModelSpec:
    if name not in REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]
