"""A float32 model from a diffusers checkpoint whose level 0 both fused gates
take, on the port (the fused kernels' plain versions on the CPU) against the
JAX package (its CPU branch, unfused).

The checkpoint: a UNet3D of zeroscope's structure at block_out_channels (64,
128), head dim 32, cross-attention at level 0, diffusers temporal style,
with a two-level VAE and a one-layer CLIP text tower (its transformers
names and layouts, drawn from a seed without importing transformers), all
stored in float32. At 4
frames of 32x64 (latent 16x32, 512 tokens a frame) the fused spatial tail
takes the level-0 spatial transformers (C = 64, S = 512) and the fused
temporal block takes transformer_in, the level-0 temporal transformers and
the mid block's (N = 128 positions at C = 128). Both packages load the
directory with ``load_diffusers_checkpoint(dtype="float32")``.

Tolerances (float32 on both sides; the port's fused kernels add the residual
and the bias in the TPU kernels' order and every product sums in another
order than XLA's, so the two differ by float32 rounding only):
* one CFG UNet call: 1e-5 of the largest output (read: 1.0e-7 against a
  largest value of 0.173, 6e-7 of it), so a bf16 operand anywhere (2^-8
  relative) or a dropped term above 1e-5 of the output fails it;
* a 2-step recorded generation: the PoI leaves are bf16 in both packages,
  and the guided eps is combined in bf16 from the UNet's bf16 outputs u and
  c, eps = u + g (c - u). A float32 difference far below a bf16 ulp flips
  the rounding of an element of u or c now and then, and the guidance
  multiplies such a flip by g = 7.5. So each leaf, given the same input
  leaf, is held elementwise to one bf16 ulp of its largest value (2^-7 *
  max) except for such flips: at most 1% of the elements beyond that ulp,
  and none beyond 2 g + 2 of them (the flips of u and c amplified, the
  final rounding). The frames within 1 uint8 level.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvdx_tpu.pipelines import text2video as jt2v
from dvdx_tpu.utils import convert as jconvert
from dvdx_tpu_torch.ops import rng as trng
from dvdx_tpu_torch.ops.kernels import spatial_tail as ttail
from dvdx_tpu_torch.ops.kernels import temporal_block as tblock
from dvdx_tpu_torch.pipelines.text2video import encode_prompts, generate
from dvdx_tpu_torch.utils import convert
from dvdx_tpu_torch.utils.testing import unet_pair_call

torch.set_num_threads(2)
GEOMETRY = dict(num_frames=4, height=32, width=64)
PROMPT = "a red panda in a snowy tree"
# launches per UNet forward at GEOMETRY: the tail in the level-0 spatial
# transformers (one down, two up), the block in transformer_in, the level-0
# temporal transformers and the mid block's
TAILS, BLOCKS = 3, 5


def _clip_text(v, hidden=64, inner=128, layers=1, positions=16, seed=23):
    """A CLIPTextModel's config and state dict (transformers' names and
    layouts), drawn from a seed: N(0, 0.02) weights as its initializer, unit
    LayerNorm scales."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g) * 0.02
    p = "text_model."
    sd = {f"{p}embeddings.token_embedding.weight": r(v, hidden),
          f"{p}embeddings.position_embedding.weight": r(positions, hidden)}
    for ln in [f"{p}encoder.layers.{i}.layer_norm{j}" for i in range(layers) for j in (1, 2)] \
            + [f"{p}final_layer_norm"]:
        sd.update({f"{ln}.weight": torch.ones(hidden), f"{ln}.bias": torch.zeros(hidden)})
    for i in range(layers):
        lp = f"{p}encoder.layers.{i}."
        for name, (o, n) in {"self_attn.q_proj": (hidden, hidden),
                             "self_attn.k_proj": (hidden, hidden),
                             "self_attn.v_proj": (hidden, hidden),
                             "self_attn.out_proj": (hidden, hidden),
                             "mlp.fc1": (inner, hidden), "mlp.fc2": (hidden, inner)}.items():
            sd.update({f"{lp}{name}.weight": r(o, n), f"{lp}{name}.bias": r(o)})
    cfg = {"vocab_size": v, "hidden_size": hidden, "intermediate_size": inner,
           "num_hidden_layers": layers, "num_attention_heads": 4,
           "max_position_embeddings": positions, "hidden_act": "gelu", "layer_norm_eps": 1e-5,
           "bos_token_id": v - 2, "eos_token_id": v - 1, "pad_token_id": v - 1}
    return cfg, sd


def _randomize(module, seed, scale=0.05):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * scale)
    return module


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from dvdx_tpu_torch.models.tokenizer import build_test_vocab, write_tokenizer_files
    from tests.torch_ref import AutoencoderKLRef, UNet3DConditionModelRef

    root = str(tmp_path_factory.mktemp("f32_ckpt"))

    def component(sub, cfg, tensors, weights="diffusion_pytorch_model.safetensors"):
        os.makedirs(f"{root}/{sub}", exist_ok=True)
        with open(f"{root}/{sub}/config.json", "w") as f:
            json.dump(cfg, f)
        convert.write_safetensors(f"{root}/{sub}/{weights}", tensors)

    unet = _randomize(UNet3DConditionModelRef(
        block_out_channels=(64, 128), layers_per_block=1, cross_levels=(True, False),
        head_dim=32, cross_dim=64, groups=8, n_temp_convs=4), seed=21)
    component("unet", {"in_channels": 4, "out_channels": 4, "block_out_channels": [64, 128],
                       "layers_per_block": 1, "attention_head_dim": 32,
                       "cross_attention_dim": 64, "norm_num_groups": 8, "norm_eps": 1e-5,
                       "down_block_types": ["CrossAttnDownBlock3D", "DownBlock3D"]},
              unet.state_dict())
    torch.manual_seed(22)
    vae = AutoencoderKLRef(latent_ch=4, block_out_channels=(16, 32), layers_per_block=1,
                           groups=4, mid_attention=True)
    component("vae", {"latent_channels": 4, "block_out_channels": [16, 32],
                      "layers_per_block": 1, "norm_num_groups": 4, "scaling_factor": 0.18215},
              vae.state_dict())
    vocab, merges = build_test_vocab(PROMPT.split())
    write_tokenizer_files(f"{root}/tokenizer", vocab, merges)
    text_cfg, text_sd = _clip_text(len(vocab))
    component("text_encoder", text_cfg, text_sd, "model.safetensors")
    with open(f"{root}/model_index.json", "w") as f:
        json.dump({"_class_name": "TextToVideoSDPipeline"}, f)
    return root


@pytest.fixture(scope="module")
def pipes(ckpt):
    ours = convert.load_diffusers_checkpoint(ckpt, dtype="float32", device="cpu")
    return ours, jconvert.load_diffusers_checkpoint(ckpt, dtype="float32")


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts of the fused kernels' plain versions (what the wrappers run on
    CPU tensors), by kernel."""
    calls = {"tail": 0, "block": 0}

    def spy(key, fn):
        def call(*args, **kwargs):
            assert args[0].dtype == torch.float32
            calls[key] += 1
            return fn(*args, **kwargs)
        return call
    monkeypatch.setattr(ttail, "fused_spatial_tail_plain",
                        spy("tail", ttail.fused_spatial_tail_plain))
    monkeypatch.setattr(tblock, "fused_temporal_block_plain",
                        spy("block", tblock.fused_temporal_block_plain))
    return calls


def test_float32_checkpoint_loads_as_float32(pipes):
    """Leaf for leaf float32, with no cast to bf16 on the way: the towers
    keep bits below bf16's."""
    ours, ref = pipes
    assert ours.spec.unet.dtype == "float32" == ref.spec.unet.dtype
    params = list(ours.parameters())
    assert {p.dtype for p in params} == {torch.float32}
    assert sum(int(not torch.equal(p, p.bfloat16().float())) for p in params) > len(params) // 2


def test_float32_unet_call_fuses_and_matches_reference(pipes, fused_calls):
    ours, ref = pipes
    hidden = encode_prompts(ours, ["", PROMPT])
    z = trng.video_noise(trng.base_key(3), 4, (16, 32, 4), device="cpu")[None]
    got = unet_pair_call(ours.unet, z, hidden, 801)
    assert fused_calls == {"tail": TAILS, "block": BLOCKS}
    ts = jnp.full((2,), 801, jnp.int32)
    want = jax.jit(ref.unet.apply)(ref.params["unet"], jnp.asarray(torch.cat([z, z]).numpy()),
                                   ts, jnp.asarray(hidden.numpy()))
    want = np.asarray(want, np.float32)
    err = np.abs(got.numpy() - want).max()
    print(f"float32 UNet call parity: max_abs_err {err:.3g}, max_abs_ref "
          f"{np.abs(want).max():.3g}")
    assert np.abs(want).max() > 0.1 and err <= 1e-5 * np.abs(want).max()


def test_float32_recorded_generation_matches_reference(pipes, fused_calls):
    """Two recorded steps. Each leaf is held given the same input: z_0 from
    the same base noise, eps_0 and z_1 from z_0, and eps_1 recomputed by the
    JAX package from the port's z_1 leaf (a leaf one bf16 ulp off would
    carry into the next step's eps through the UNet's gain)."""
    ours, ref = pipes
    kw = dict(seed=5, num_steps=2, guidance_scale=7.5, record=True, **GEOMETRY)
    vt, (zt, et, tt) = generate(ours, PROMPT, **kw)
    assert fused_calls == {"tail": 2 * TAILS, "block": 2 * BLOCKS}
    vj, (zj, ej, tj) = jt2v.generate(ref, PROMPT, **kw)
    np.testing.assert_array_equal(tt, tj)
    assert zt.dtype == et.dtype == torch.bfloat16
    h = jt2v.encode_prompts(ref, ["", PROMPT])
    _, _, ej1 = jax.jit(lambda p, z: jt2v.denoise(
        ref.unet.apply, p, jt2v.make_ddim_schedule(2), z, h[1:2], h[0:1], 7.5, record=True,
        step_range=(1, 2)))(ref.params["unet"], jnp.asarray(zt[1].float().numpy(), jnp.bfloat16))
    held = {"z_0": (zt[0], zj[0]), "eps_0": (et[0], ej[0]), "z_1": (zt[1], zj[1]),
            "eps_1 from the port's z_1": (et[1], ej1[0])}
    for name, (got, want) in held.items():
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        diff, ulp = np.abs(got - want), 2.0 ** -7 * np.abs(want).max()
        beyond = float((diff > ulp).mean())
        print(f"float32 generation parity: {name} max_abs_err {diff.max():.3g} "
              f"({diff.max() / ulp:.2f} ulp of the largest value, {np.abs(want).max():.3g}); "
              f"beyond one ulp: {beyond:.2%} of the elements")
        assert beyond <= 0.01 and diff.max() <= (2 * 7.5 + 2) * ulp, name
    frames = np.abs(vt.astype(int) - vj.astype(int)).max()
    print(f"float32 generation parity: frames {frames} levels")
    assert frames <= 1 and vt.std() > 0
