"""Model registry, the counterpart of ``dvdx_tpu/models/zoo.py``.

zeroscope-v2-576w and zeroscope-v2-xl share one architecture (the ModelScope
UNet3D) and differ in their native geometry; zeroscope-tiny-hf is the same
block structure at CPU-test scale, and zeroscope-tiny the CPU-test scale of
the rotary temporal style, the mock network's default model. svd-img2vid is
the SVD-class image-to-video family (the zeroscope UNet taking the noise
latent concatenated with the conditioning image's latent, 8 channels in).

cogvideox-5b is the JAX package's CogVideoX-class design (``VideoDiT``: a
CLIP-shaped text tower at width 4096, one adaLN modulation for text and
video, no QK-norm, LayerNorms without scale or bias, 48 latent frames), kept
as the JAX package has it; it is not the published model. cogvideox-5b-hf
is the published CogVideoX-5B (THUDM/CogVideoX-5b, diffusers' layout):
``models.cogvideox.CogVideoXTransformer`` over a T5 v1.1 XXL encoder
(``models.t5``), sampled by v-prediction DDIM with zero-terminal-SNR
alpha-bar and trailing spacing; its decoder is the port's per-frame KL
decoder at the 5B VAE's widths, 16 latent channels and scaling factor, one
frame a latent frame (the published 3D causal VAE, 4x in time, is not
ported).
svd-tiny, dit-tiny and cogvideox-tiny-hf are the CPU-test scales.
``REGISTRY`` holds the JAX package's names, one for one; ``PUBLISHED`` the
published models it does not have (cogvideox-5b-hf, cogvideox-tiny-hf).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

from ..ops.scheduler import DDIMSchedule, make_ddim_schedule
from .cogvideox import CogVideoXConfig, tiny_cogvideox_config
from .dit_video import DiTVideoConfig, tiny_dit_config
from .t5 import T5Config, tiny_t5_config
from .text_encoder import TextEncoderConfig, tiny_text_config
from .unet3d import UNet3DConfig, tiny_hf_unet_config, tiny_unet_config
from .vae import VAEConfig, tiny_vae_config


# make_ddim_schedule's settings by model kind, where they are not zeroscope's
# (leading spacing, alpha-bar as trained): the published CogVideoX
# scheduler_config.json's (CogVideoXDDIMScheduler; its snr_shift_scale 1.0 is
# the identity)
SCHEDULES = {"cogvideox": dict(timestep_spacing="trailing", rescale_zero_snr=True,
                               set_alpha_to_one=True)}


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    text: Union[TextEncoderConfig, T5Config]
    vae: VAEConfig
    kind: str = "unet3d"                        # unet3d | dit | cogvideox
    unet: Optional[UNet3DConfig] = None
    # the DiT's config: a VideoDiT's, or the published CogVideoX's
    dit: Optional[Union[DiTVideoConfig, CogVideoXConfig]] = None
    prediction_type: str = "epsilon"            # epsilon | v_prediction
    conditioning: str = "text"                  # text | image (img2vid)
    default_width: int = 576
    default_height: int = 320
    default_frames: int = 16
    default_steps: int = 25
    default_guidance_scale: float = 7.5

    @property
    def denoiser_config(self) -> Union[UNet3DConfig, DiTVideoConfig, CogVideoXConfig]:
        return self.unet if self.kind == "unet3d" else self.dit

    def ddim_schedule(self, num_steps: int) -> DDIMSchedule:
        """The family's DDIM schedule at ``num_steps``: what miner, validator
        and every sampler of the family run."""
        return make_ddim_schedule(num_steps, prediction_type=self.prediction_type,
                                  **SCHEDULES.get(self.kind, {}))

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


# published models the JAX package does not register, in diffusers' layout
PUBLISHED: Dict[str, ModelSpec] = {
    "cogvideox-tiny-hf": ModelSpec(
        name="cogvideox-tiny-hf", kind="cogvideox", dit=tiny_cogvideox_config(),
        text=tiny_t5_config(),
        vae=dataclasses.replace(tiny_vae_config(), latent_channels=16, scaling_factor=0.7),
        prediction_type="v_prediction", default_width=24, default_height=16, default_frames=2,
        default_steps=4, default_guidance_scale=6.0),
    # THUDM/CogVideoX-5b: transformer/config.json, text_encoder/config.json,
    # scheduler/scheduler_config.json (CogVideoXDDIMScheduler, snr_shift_scale
    # 1.0: the identity); vae/config.json's latent channels, scaling factor and
    # decoder widths on the port's per-frame KL decoder
    "cogvideox-5b-hf": ModelSpec(
        name="cogvideox-5b-hf", kind="cogvideox", dit=CogVideoXConfig(), text=T5Config(),
        vae=VAEConfig(latent_channels=16, base_channels=128, channel_mults=(1, 2, 2, 4),
                      layers_per_block=3, use_mid_attention=False, final_tanh=False,
                      scaling_factor=0.7),
        prediction_type="v_prediction", default_width=720, default_height=480, default_frames=13,
        default_steps=50, default_guidance_scale=6.0),
}


def get_model_spec(name: str) -> ModelSpec:
    spec = REGISTRY.get(name) or PUBLISHED.get(name)
    if spec is None:
        raise KeyError(f"unknown model {name!r}; available: {sorted(REGISTRY) + sorted(PUBLISHED)}")
    return spec
