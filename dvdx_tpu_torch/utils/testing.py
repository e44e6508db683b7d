"""Test and smoke-run helpers.

A freshly initialised model has zero-init output projections (temporal
mixers, spatial transformer proj_out, the UNet's conv_out) and zero biases,
so eps is identically 0 and the temporal paths are multiplied by zero.
``perturb_zero_params`` fills every all-zero parameter with small seeded
noise so that signal flows through every layer, bit for bit as the
reference's ``dvdx_tpu/utils/testing.py`` does for the same weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..models import text_encoder, unet3d, vae, zoo
from ..ops import rng
from ..ops.scheduler import make_ddim_schedule
from ..pipelines.text2video import Pipeline, build_pipeline, encode_prompts
from .bridge import flax_leaves
from .init import drawn

# The reference check (``chip_smoke.py``): one UNet call of
# ``reference_check_pipeline`` on the card (its kernels) against the same
# call on the CPU (the plain versions), both bf16, may differ by this
# relative RMS,
# ||eps_card - eps_cpu|| / ||eps_cpu||. The model's own bf16 spread (bf16
# against float32 on the CPU) and the distance a 3% fault in one kernel's
# output makes are measured by tests/test_torch_reference_check.py.
REFERENCE_RELRMS_TOL = 0.03


@torch.no_grad()
def perturb_zero_params(obj: nn.Module, seed: int = 0, scale: float = 0.02) -> nn.Module:
    """Replace every all-zero parameter with N(0, scale) noise, in place, as
    the reference's ``perturb_zero_params`` does to the same weights: the
    index i runs over the leaves of the reference's whole tree in
    ``jax.tree.flatten`` order (``utils.bridge.flax_leaves``; for a
    pipeline {'text', 'unet', 'vae_dec'} with their ``params`` levels), and
    leaf i gets numpy ``default_rng(seed * 100003 + i).normal(0, scale)`` in
    the flax shape, in float64, cast to the leaf's dtype (through float32,
    as ``ml_dtypes`` casts float64 to bfloat16), then moved into the port's
    layout."""
    zero = [(i, leaf) for i, leaf in enumerate(flax_leaves(obj))
            if leaf.param.numel() and not leaf.param.any()]

    def draw(item):
        i, leaf = item
        noise = np.random.default_rng(seed * 100003 + i).normal(0.0, scale, leaf.shape)
        return torch.from_numpy(noise.astype(np.float32))

    for (_, leaf), value in drawn(zero, draw):
        leaf.param.copy_(leaf.to_torch(value.to(leaf.param.device).to(leaf.param.dtype)))
    return obj


def amplify_temporal_params(obj: nn.Module, gain: float) -> nn.Module:
    """Scale the temporal mixers' output leaves (zero-init at birth:
    ``temporal_attn/to_out_zero``, ``temp_conv/conv*_zero``) by ``gain``,
    in place. A perturbed-zero model couples frames only at the
    perturbation's scale; amplifying the temporal outputs moves the random
    parameter point toward a trained model's strong frame coupling, so
    chunk-boundary metrics have signal at toy scale (the reference's
    ``amplify_temporal_params``)."""
    return _amplify_matching(obj, gain, lambda ks: ("temporal_attn" in ks or "temp_conv" in ks)
                             and "zero" in ks)


def amplify_output_params(obj: nn.Module, gain: float) -> nn.Module:
    """Scale the UNet's zero-init output conv (``conv_out_zero``) by
    ``gain``, in place, so eps matters against the base noise (the
    reference's ``amplify_output_params``)."""
    return _amplify_matching(obj, gain, lambda ks: "conv_out_zero" in ks)


@torch.no_grad()
def _amplify_matching(obj: nn.Module, gain: float, match) -> nn.Module:
    """Multiply the leaves whose reference key string (``['unet']['params']
    ['conv_out_zero']['kernel']``, as ``jax.tree_util.keystr`` writes it)
    matches by ``gain``: in float32 with gain rounded to float32, then cast
    to the leaf's dtype, as numpy multiplies a float32 or bfloat16 leaf by
    a Python float."""
    g = torch.tensor(gain, dtype=torch.float32)
    for leaf in flax_leaves(obj):
        if match("".join(f"['{k}']" for k in leaf.path)):
            leaf.param.copy_((leaf.param.float() * g.to(leaf.param.device)).to(leaf.param.dtype))
    return obj


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
