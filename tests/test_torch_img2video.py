"""Port vs reference: the img2vid family (svd-tiny, float32, the reference's
perturbed weights bridged into the port): the VAE encoder, the conditioning
inputs, and ``generate_from_image`` with PoI recording.

Tolerances: the VAE encoder agrees with the reference to 1e-4 absolute, as
the decoder does (``tests/test_torch_models.py``; measured below 1e-5). The
conditioning latent carries the encoder's error and the augmentation
(``aux_noise``, within 3 float32 ulps of JAX's) to 1e-4, and the pooled
one-token context to 1e-5. ``generate_from_image`` rounds eps and z to bf16
leaves, so a small difference can flip one bf16 rounding, which the chain
carries: over 3 steps z and eps within 0.0625 (measured 0.0078 / 0.0059), z_0
bit-equal, >= 95% of z bit-equal, frames within 2 levels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvdx_tpu.models.vae import VAEConfig as JVAEConfig
from dvdx_tpu.models.vae import VAEEncoder as JVAEEncoder
from dvdx_tpu.models.vae import tiny_vae_config as j_tiny_vae
from dvdx_tpu.ops import rng as jrng
from dvdx_tpu.pipelines.img2video import build_img2video_pipeline as jbuild_img2video
from dvdx_tpu.pipelines.img2video import generate_from_image as jgenerate_from_image
from dvdx_tpu.utils.testing import perturb_zero_params as jperturb
from dvdx_tpu_torch.models.vae import VAEEncoder, tiny_vae_config
from dvdx_tpu_torch.ops import rng as trng
from dvdx_tpu_torch.pipelines.img2video import (build_img2video_pipeline, conditioning,
                                                generate_from_image, load_img2video_params)
from dvdx_tpu_torch.pipelines.text2video import build_pipeline
from dvdx_tpu_torch.utils.bridge import load_jax_params

torch.set_num_threads(2)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _report(what, got, want):
    got, want = _f32(got), _f32(want)
    print(f"{what}: max_abs_err {np.abs(got - want).max():.3g}, "
          f"max_abs_ref {np.abs(want).max():.3g}")  # shown by pytest -rP


def _image(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, (32, 32, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def svd_pipes():
    """(the reference's svd-tiny with perturbed zero leaves, the port's
    svd-tiny holding the same weights, VAE encoder included)."""
    ref = jbuild_img2video("svd-tiny", seed=0)
    ref.base.params = jperturb(ref.base.params, seed=99)
    port = build_img2video_pipeline("svd-tiny", device="cpu")
    return ref, load_img2video_params(port, jax.tree.map(np.asarray, ref.base.params))


@pytest.mark.parametrize("mid_attention", [False, True])
def test_vae_encoder_matches_reference(mid_attention):
    """The tiny VAE's encoder, and the same with the full VAE's single-head
    mid-attention, on flax-initialised weights."""
    jcfg = dataclasses.replace(j_tiny_vae(), use_mid_attention=mid_attention)
    x = np.random.default_rng(2).uniform(-1, 1, size=(2, 16, 24, 3)).astype(np.float32)
    jenc = JVAEEncoder(jcfg)
    params = jax.jit(jenc.init)(jax.random.key(0), x)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.01, params)  # no zero leaves
    port = VAEEncoder(dataclasses.replace(tiny_vae_config(), use_mid_attention=mid_attention))
    load_jax_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jenc.apply)(params, x))
    _report("VAEEncoder", got, want)
    assert got.shape == (2, 8, 12, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_bridged_encoder_matches_reference(svd_pipes):
    ref, port = svd_pipes
    img = _image(3).astype(np.float32)[None] / 127.5 - 1.0
    want = np.asarray(jax.jit(ref.vae_encoder.apply)(ref.base.params["vae_enc"], img))
    with torch.no_grad():
        got = port.vae_encoder(torch.from_numpy(img)).numpy()
    _report("bridged VAEEncoder", got, want)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_conditioning_matches_reference(svd_pipes):
    """The augmented conditioning latent, and the one-token context: the
    latent's spatial mean zero-padded to the cross-attention width, with an
    all-zero unconditional context."""
    ref, port = svd_pipes
    img = _image(4).astype(np.float32) / 127.5 - 1.0
    seed, cond_aug = 11, 0.02
    lat = jax.jit(ref.vae_encoder.apply)(ref.base.params["vae_enc"], img[None])[0]
    want = lat + cond_aug * jrng.aux_noise(jrng.base_key(seed), lat, tag=7)
    with torch.no_grad():
        got, ctx, uncond = conditioning(port, torch.from_numpy(img),
                                        trng.base_key(seed), cond_aug)
    _report("conditioning latent", got, want)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    width = port.spec.unet.cross_attention_dim
    assert ctx.shape == uncond.shape == (1, 1, width) and not uncond.any()
    np.testing.assert_allclose(ctx[0, 0, :4].numpy(), np.asarray(want).mean(axis=(0, 1)),
                               atol=1e-5, rtol=0)
    assert not ctx[..., 4:].any()


def test_generate_from_image_matches_reference(svd_pipes):
    ref, port = svd_pipes
    image = _image(0)
    kw = dict(seed=5, num_frames=2, num_steps=3, record=True)
    vj, (zj, ej, tj) = jgenerate_from_image(ref, image, **kw)
    vt, (zt, et, tt) = generate_from_image(port, image, **kw)
    np.testing.assert_array_equal(tt, tj)
    assert zt.shape == zj.shape == (3, 1, 2, 16, 16, 4) and zt.dtype == torch.bfloat16
    assert vt.shape == vj.shape == (2, 32, 32, 3) and vt.dtype == np.uint8
    np.testing.assert_array_equal(_f32(zt[0]), _f32(zj[0]))
    _report("generate_from_image z", zt, zj)
    _report("generate_from_image eps", et, ej)
    np.testing.assert_allclose(_f32(zt), _f32(zj), atol=0.0625, rtol=0)
    np.testing.assert_allclose(_f32(et), _f32(ej), atol=0.0625, rtol=0)
    assert (_f32(zt) == _f32(zj)).mean() >= 0.95
    assert np.abs(vt.astype(int) - vj.astype(int)).max() <= 2


def test_generate_from_image_deterministic_and_conditioned(svd_pipes):
    """The same request twice gives the same bits; another image, another
    video."""
    _, port = svd_pipes
    kw = dict(seed=5, num_frames=2, num_steps=2)
    a = generate_from_image(port, _image(0), record=True, **kw)
    b = generate_from_image(port, _image(0), record=True, **kw)
    assert np.array_equal(a[0], b[0])
    assert torch.equal(a[1][0], b[1][0]) and torch.equal(a[1][1], b[1][1])
    assert not np.array_equal(a[0], generate_from_image(port, _image(1), **kw))


def test_img2video_defaults_are_the_spec():
    """Without geometry the request takes the family's frames, steps and
    guidance (svd-tiny: 4 frames, 4 steps, 3.0)."""
    port = build_img2video_pipeline("svd-tiny", seed=2, device="cpu")
    video, (zs, epss, ts) = generate_from_image(port, _image(2), record=True)
    assert video.shape == (4, 32, 32, 3) and zs.shape == (4, 1, 4, 16, 16, 4)
    assert len(ts) == 4 and port.spec.default_guidance_scale == 3.0


def test_img2video_needs_an_image_family():
    """Each pipeline refuses the other's families by name (a text request on
    svd-tiny would otherwise fail deep in the UNet's first convolution)."""
    from dvdx_tpu_torch.pipelines.text2video import generate

    with pytest.raises(ValueError, match="image-conditioned"):
        build_img2video_pipeline("zeroscope-tiny", device="cpu")
    with pytest.raises(ValueError, match="generate_from_image"):
        generate(build_pipeline("svd-tiny", device="cpu"), "a red ball", num_frames=2)


def test_bridge_vae_enc_goes_with_img2video(svd_pipes):
    """'vae_enc' loads into an Img2VideoPipeline's encoder (the loaded
    encoder's weights are the bridged ones), and a tree without it does not
    load into an img2vid pipeline."""
    ref, port = svd_pipes
    tree = jax.tree.map(np.asarray, ref.base.params)
    fresh = build_img2video_pipeline("svd-tiny", seed=5, device="cpu")
    loaded = load_img2video_params(fresh, tree)
    for (name, a), (_, b) in zip(loaded.state_dict().items(), port.state_dict().items()):
        assert torch.equal(a, b), name
    without = {k: v for k, v in tree.items() if k != "vae_enc"}
    with pytest.raises(KeyError, match="vae_enc"):
        load_img2video_params(build_img2video_pipeline("svd-tiny", device="cpu"), without)


def test_svd_unet_takes_the_concatenated_latent():
    """svd-img2vid's UNet at full width takes 8 channels in and gives 4 out,
    and its VAE encoder has the reference's parameter count (the meta device
    and abstract flax shapes: no weights)."""
    from dvdx_tpu_torch.pipelines.text2video import empty_pipeline
    from dvdx_tpu_torch.models.zoo import get_model_spec

    with torch.device("meta"):
        pipe = empty_pipeline(get_model_spec("svd-img2vid"), device="meta")
    assert tuple(pipe.unet.conv_in.weight.shape) == (320, 8, 3, 3)
    assert tuple(pipe.unet.conv_out_zero.weight.shape) == (4, 320, 3, 3)
    with torch.device("meta"):
        enc = VAEEncoder(get_model_spec("svd-img2vid").vae)
    assert sum(p.numel() for p in enc.parameters()) == sum(
        np.prod(s.shape) for s in jax.tree_util.tree_leaves(jax.eval_shape(
            JVAEEncoder(JVAEConfig()).init, jax.random.key(0),
            jnp.zeros((1, 16, 16, 3), jnp.float32))))
