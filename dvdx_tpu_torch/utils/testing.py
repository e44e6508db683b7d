"""Test and smoke-run helpers.

A freshly initialised model has zero-init output projections (temporal
mixers, spatial transformer proj_out, the UNet's conv_out) and zero biases,
so eps is identically 0 and the temporal paths are multiplied by zero.
``perturb_zero_params`` fills every all-zero parameter with small seeded
noise so that signal flows through every layer, as the reference's
``dvdx_tpu/utils/testing.py`` does for its parameter trees.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..models import text_encoder, unet3d, vae, zoo
from ..ops import rng
from ..ops.scheduler import make_ddim_schedule
from ..pipelines.text2video import Pipeline, build_pipeline, encode_prompts

# The reference check (``chip_smoke.py``): one UNet call of
# ``reference_check_pipeline`` on the card (its kernels) against the same
# call on the CPU (the plain versions), both bf16, may differ by this
# relative RMS,
# ||eps_card - eps_cpu|| / ||eps_cpu||. The model's own bf16 spread (bf16
# against float32 on the CPU) and the distance a 3% fault in one kernel's
# output makes are measured by tests/test_torch_reference_check.py.
REFERENCE_RELRMS_TOL = 0.03


@torch.no_grad()
def perturb_zero_params(module: nn.Module, seed: int = 0,
                        scale: float = 0.02) -> nn.Module:
    """Replace every all-zero parameter with N(0, scale) noise, in place,
    drawn on the parameter's device from a generator seeded per parameter."""
    for i, param in enumerate(module.parameters()):
        if param.numel() and not param.any():
            gen = torch.Generator(device=param.device).manual_seed(seed * 100003 + i)
            noise = torch.randn(param.shape, generator=gen, device=param.device,
                                dtype=torch.float32)
            param.copy_(noise * scale)
    return module


def reference_check_spec(dtype: str) -> zoo.ModelSpec:
    """A zeroscope-structured model small enough for the CPU whose shapes
    every kernel of the model path takes on the card: UNet widths 64 / 128 /
    128 / 128 with cross-attention at level 0, and 4 frames at 64x64. The
    32x32 latents give level 0 1024 tokens, so its spatial transformer runs
    flash attention and the fused tail, and its temporal transformers and
    ``transformer_in`` the fused block; the mid block sits at 4x4 latents
    (16 positions), where both fused gates refuse, so its spatial and
    temporal transformers run the unfused modules (frame-axis attention,
    GEGLU)."""
    return dataclasses.replace(
        zoo.get_model_spec("zeroscope-tiny-hf"), name="reference-check",
        unet=dataclasses.replace(unet3d.UNet3DConfig(), block_out_channels=(64, 128, 128, 128),
                                 layers_per_block=1,
                                 cross_attention_levels=(True, False, False, False),
                                 cross_attention_dim=64, dtype=dtype),
        text=dataclasses.replace(text_encoder.tiny_text_config(), dtype=dtype),
        vae=dataclasses.replace(vae.tiny_vae_config(), dtype=dtype),
        default_width=64, default_height=64, default_frames=4)


def unet_pair_call(unet: nn.Module, z: torch.Tensor, hidden: torch.Tensor,
                   timestep: int) -> torch.Tensor:
    """The batched CFG UNet call of one denoise step: latents z (1, F, h, w,
    C) twice, hidden (2, T, D) [uncond, cond] -> float32 eps (2, F, h, w, C)."""
    ts = torch.full((2,), timestep, dtype=torch.int32, device=z.device)
    with torch.inference_mode():
        return unet(torch.cat([z, z]), ts, hidden).float()


def reference_check_pipeline(dtype: str = "bfloat16", device="cpu") -> Pipeline:
    """The reference check's model: seeded random weights drawn on the CPU
    in bf16, zero-init leaves perturbed at scale 0.1 (so the temporal and
    transformer branches carry weight into eps), loaded into a pipeline of
    ``dtype`` on ``device``."""
    base = perturb_zero_params(build_pipeline(reference_check_spec("bfloat16"),
                                              seed=5, device="cpu"), seed=11, scale=0.1)
    if dtype == "bfloat16" and torch.device(device).type == "cpu":
        return base
    pipe = build_pipeline(reference_check_spec(dtype), device=device)
    pipe.load_state_dict(base.state_dict())
    return pipe


def reference_check_inputs(pipe: Pipeline):
    """(z, hidden, timestep) of the reference check, on the CPU: the base
    noise of seed 3 as bf16 latents (1, 4, 32, 32, 4), the [negative,
    prompt] encoding, and the first timestep of a 25-step schedule."""
    hidden = encode_prompts(pipe, ["", "a red ball"])
    z = rng.video_noise(rng.base_key(3), 4, (32, 32, 4), device="cpu")[None]
    return z.bfloat16(), hidden, int(make_ddim_schedule(25).timesteps[0])


def relative_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float32."""
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()
