"""Port vs reference: text encoder, VAE decoder and UNet3D through the weight
bridge, on the same numpy-seeded inputs.

float32 (zeroscope-tiny-hf widths): the port computes the reference's formula
with other summation orders, so outputs agree to ~1e-6; the UNet is held to
atol 1e-3, the bound tests/test_xl_parity.py uses for the reference against
diffusers semantics, the text encoder and VAE to 1e-4. bfloat16 UNet: both
sides round every layer's output to bf16, but at different points inside
fused ops (XLA keeps excess precision across elementwise chains, the port's
GroupNorm+SiLU rounds once), so one-ulp differences enter at every layer and
are carried through ~20 layers (measured: 0.018 at max|eps| 0.99); bound
0.05 of the output's scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvdx_tpu.models.text_encoder import tokenize_batch as j_tokenize_batch
from dvdx_tpu.models.unet3d import UNet3D as JUNet3D
from dvdx_tpu.models.vae import VAEDecoder as JVAEDecoder
from dvdx_tpu.models.vae import tiny_vae_config as j_tiny_vae
from dvdx_tpu_torch.models.text_encoder import tokenize_batch
from dvdx_tpu_torch.models.unet3d import UNet3D, tiny_hf_unet_config
from dvdx_tpu_torch.models.vae import VAEDecoder, tiny_vae_config
from dvdx_tpu_torch.pipelines.text2video import build_pipeline
from dvdx_tpu_torch.utils.bridge import load_jax_params, load_pipeline_params

torch.set_num_threads(2)


def _report(got, want):
    """Print the measured error beside the bound (shown by pytest -rP)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    print(f"parity: max_abs_err {np.abs(got - want).max():.3g}, "
          f"max_abs_ref {np.abs(want).max():.3g}")


@pytest.fixture(scope="module")
def bridged(tiny_hf_pipeline):
    """(reference pipeline, port pipeline holding the same weights)."""
    tree = jax.tree.map(np.asarray, tiny_hf_pipeline.params)
    port = build_pipeline("zeroscope-tiny-hf", device="cpu")
    return tiny_hf_pipeline, load_pipeline_params(port, tree)


def test_tokenizer_ids_equal(bridged):
    ref, port = bridged
    texts = ["a red ball", "", "A Lighthouse at dusk, waves crashing!", "x " * 40]
    np.testing.assert_array_equal(port.tokenize(texts), ref.tokenize(texts))
    np.testing.assert_array_equal(tokenize_batch(texts), j_tokenize_batch(texts))


def test_text_encoder_matches(bridged):
    ref, port = bridged
    ids = ref.tokenize(["", "a red panda rides a bicycle"])
    want_h, want_p = jax.jit(ref.text_encoder.apply)(ref.params["text"], ids)
    with torch.no_grad():
        got_h, got_p = port.text_encoder(torch.from_numpy(ids).long())
    _report(got_h.numpy(), want_h)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-4, rtol=0)


def test_vae_decoder_matches(bridged):
    ref, port = bridged
    z = np.random.default_rng(1).normal(size=(2, 16, 16, 4)).astype(np.float32)
    want = jax.jit(ref.vae_decoder.apply)(ref.params["vae_dec"], z)
    with torch.no_grad():
        got = port.vae_decoder(torch.from_numpy(z))
    assert got.shape == (2, 32, 32, 3)
    _report(got.numpy(), want)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_vae_decoder_mid_attention_matches():
    """The full VAE's single-head mid-attention (the plain attention path,
    D = C) at a tiny width, with flax-initialised weights."""
    jcfg = dataclasses.replace(j_tiny_vae(), use_mid_attention=True)
    z = np.random.default_rng(2).normal(size=(1, 8, 8, 4)).astype(np.float32)
    jdec = JVAEDecoder(jcfg)
    params = jax.jit(jdec.init)(jax.random.key(0), z)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.01, params)  # no zero leaves
    port = VAEDecoder(dataclasses.replace(tiny_vae_config(), use_mid_attention=True))
    load_jax_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(z)).numpy()
    want = np.asarray(jax.jit(jdec.apply)(params, z))
    _report(got, want)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _unet_inputs():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(2, 4, 16, 16, 4)).astype(np.float32),
            np.array([801, 21], np.int32),
            rng.normal(size=(2, 16, 64)).astype(np.float32))


def test_unet_float32_matches(bridged):
    ref, port = bridged
    lat, ts, ctx = _unet_inputs()
    want = np.asarray(jax.jit(ref.unet.apply)(ref.params["unet"], lat, ts, ctx))
    with torch.no_grad():
        got = port.unet(*(torch.from_numpy(a) for a in (lat, ts, ctx))).numpy()
    assert np.abs(want).max() > 0.1  # perturbed zero leaves: eps is not trivially 0
    _report(got, want)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_unet_bfloat16_close(tiny_hf_pipeline):
    jcfg = dataclasses.replace(tiny_hf_pipeline.unet.cfg, dtype="bfloat16")
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                          tiny_hf_pipeline.params["unet"])
    lat, ts, ctx = _unet_inputs()
    lat16, ctx16 = jnp.asarray(lat, jnp.bfloat16), jnp.asarray(ctx, jnp.bfloat16)
    want = np.asarray(jax.jit(JUNet3D(jcfg).apply)(params, lat16, ts, ctx16)
                      .astype(jnp.float32))
    port = UNet3D(dataclasses.replace(tiny_hf_unet_config(), dtype="bfloat16"))
    load_jax_params(port.to(torch.bfloat16), jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = port(torch.from_numpy(lat).bfloat16(), torch.from_numpy(ts),
                   torch.from_numpy(ctx).bfloat16()).float().numpy()
    _report(got, want)
    err = np.abs(got - want).max()
    assert err <= 0.05 * np.abs(want).max(), (err, np.abs(want).max())


# --- the rotary temporal style (zeroscope-tiny) -------------------------------
# float32 on both sides; each case is held to 1e-5 of the reference output's
# max |value| (measured: ~1e-7 of it for the modules, ~1e-6 for the UNet).

ROTARY_RTOL_OF_MAX = 1e-5


def _within_scale(got, want, frac=ROTARY_RTOL_OF_MAX):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    _report(got, want)
    assert np.abs(got - want).max() <= frac * np.abs(want).max()


@pytest.mark.parametrize("offset", [0, 5, 13])
def test_rotary_embed_matches(offset):
    """Absolute positions offset as a frame chunk of a longer clip sees them."""
    from dvdx_tpu.models.layers import rotary_embed as j_rotary
    from dvdx_tpu_torch.models.layers import rotary_embed

    x = np.random.default_rng(offset).normal(size=(3, 6, 4, 16)).astype(np.float32)
    pos = np.arange(6) + offset
    want = jax.jit(j_rotary)(x, pos)
    got = rotary_embed(torch.from_numpy(x), torch.from_numpy(pos))
    _within_scale(got.numpy(), want)


@pytest.mark.parametrize("offset,use_rotary", [(0, True), (7, True), (0, False)])
def test_temporal_attention_matches(offset, use_rotary):
    from dvdx_tpu.models.layers import TemporalAttention as JTemporalAttention
    from dvdx_tpu.utils.init import fast_init
    from dvdx_tpu.utils.testing import perturb_zero_params
    from dvdx_tpu_torch.models.layers import TemporalAttention

    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 5, 3, 4, 32)).astype(np.float32)
    pos = np.arange(5) + offset
    jmod = JTemporalAttention(2, 16, use_rotary, jnp.float32)
    params = perturb_zero_params(fast_init(jmod, 0, jnp.asarray(x), jnp.asarray(pos)), seed=3)
    want = jax.jit(jmod.apply)(params, x, pos)
    port = load_jax_params(TemporalAttention(32, 2, 16, use_rotary),
                           jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(pos))
    _within_scale(got.numpy(), want)


@pytest.fixture(scope="module")
def bridged_rotary(tiny_pipeline):
    """(reference zeroscope-tiny, the port's holding the same weights)."""
    tree = jax.tree.map(np.asarray, tiny_pipeline.params)
    return tiny_pipeline, load_pipeline_params(build_pipeline("zeroscope-tiny", device="cpu"),
                                               tree)


def test_zeroscope_tiny_spec_matches(bridged_rotary):
    from dvdx_tpu.models.zoo import get_model_spec as j_spec
    from dvdx_tpu_torch.models.zoo import get_model_spec

    port, ref = get_model_spec("zeroscope-tiny"), j_spec("zeroscope-tiny")
    for field in ("block_out_channels", "layers_per_block", "cross_attention_levels",
                  "attention_head_dim", "cross_attention_dim", "norm_groups",
                  "temporal_conv_layers", "use_rotary_time", "temporal_style", "dtype"):
        assert getattr(ref.unet, field) == getattr(port.unet, field), field
    assert (ref.default_width, ref.default_height, ref.default_frames, ref.default_steps) == \
        (port.default_width, port.default_height, port.default_frames, port.default_steps)


@pytest.mark.parametrize("offset", [0, 4])
def test_unet_rotary_float32_matches(bridged_rotary, offset):
    """The whole zeroscope-tiny UNet (rotary transformer_in and temporal
    mixers, one temporal conv per level), positions offset as under
    chunking."""
    ref, port = bridged_rotary
    rng = np.random.default_rng(2 + offset)
    z = rng.normal(size=(2, 4, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(2, 16, 64)).astype(np.float32)
    ts = np.array([981, 21], np.int32)
    pos = np.arange(4) + offset
    want = jax.jit(lambda p, *a: JUNet3D(ref.spec.unet).apply(p, *a))(
        ref.params["unet"], z, ts, ctx, pos)
    with torch.no_grad():
        got = port.unet(torch.from_numpy(z), torch.from_numpy(ts), torch.from_numpy(ctx),
                        torch.from_numpy(pos))
    _within_scale(got.numpy(), want)
