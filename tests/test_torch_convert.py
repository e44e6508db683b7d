"""The port's checkpoint converter against the JAX package's.

Both converters map diffusers / transformers state dicts (written by
``tests/torch_ref.py`` and transformers' own CLIP models) onto the same
nested parameter tree, so the trees must be equal key for key and bitwise in
float32, and each must refuse a checkpoint with a missing or an extra key.
The port's own safetensors reader and writer are held to the ``safetensors``
package byte for byte. Model outputs through the converted trees are held to
the torch references at the tolerances the JAX package's tests use (2e-5 /
1e-4 for the CLIP towers, 5e-4 / 1e-3 for the UNet and VAE, float32).
"""

import json
import os

import numpy as np
import pytest
import torch

from dvdx_tpu.models.unet3d import UNet3DConfig as JUNet3DConfig
from dvdx_tpu.models.unet3d import tiny_hf_unet_config as jtiny_hf_unet_config
from dvdx_tpu.utils import convert as jconvert
from dvdx_tpu_torch.models.clip_vision import CLIPVisionEncoder, VisionConfig
from dvdx_tpu_torch.models.text_encoder import CLIPTextEncoder, TextEncoderConfig
from dvdx_tpu_torch.models.unet3d import UNet3D, UNet3DConfig, tiny_hf_unet_config
from dvdx_tpu_torch.models.vae import VAEConfig, VAEDecoder
from dvdx_tpu_torch.utils import convert
from dvdx_tpu_torch.utils.bridge import load_jax_params

torch.set_num_threads(2)


def _sd_numpy(module: torch.nn.Module):
    return {k: v.detach().float().numpy() for k, v in module.state_dict().items()}


def _randomize(module: torch.nn.Module, scale=0.05, seed=0):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * scale)
    return module


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def assert_trees_equal(ours, ref):
    a, b = _flat(ours), _flat(ref)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


# --- safetensors ----------------------------------------------------------------


def test_safetensors_reader_and_writer_match_the_package(tmp_path):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"w.f32": torch.randn(3, 5, generator=g),
               "w.f16": torch.randn(7, generator=g).half(),
               "w.bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
               "ids": torch.arange(5, dtype=torch.int64), "scalar": torch.tensor(2.5)}
    save_file(tensors, str(tmp_path / "lib.safetensors"))
    got = convert.read_safetensors(str(tmp_path / "lib.safetensors"))
    for k, t in tensors.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], t.float().numpy())
    n = convert.write_safetensors(str(tmp_path / "ours.safetensors"), tensors)
    assert n == os.path.getsize(tmp_path / "ours.safetensors")
    back = load_file(str(tmp_path / "ours.safetensors"))
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k


# --- UNet3D -----------------------------------------------------------------------


UNETS = {
    # (torch_ref kwargs, port config, JAX config)
    "tiny": (dict(block_out_channels=(32, 64), layers_per_block=1,
                  cross_levels=(True, False), head_dim=16, cross_dim=64, groups=8,
                  n_temp_convs=4), tiny_hf_unet_config(), jtiny_hf_unet_config()),
    # the zeroscope / XL block structure at CPU widths (tests/test_xl_parity.py)
    "xl_structure": (dict(block_out_channels=(40, 64, 80, 96), layers_per_block=2,
                          cross_levels=(True, True, True, False), head_dim=8,
                          cross_dim=32, groups=8, n_temp_convs=4), None, None),
}


def _unet_configs(name):
    kw, cfg, jcfg = UNETS[name]
    if cfg is None:
        common = dict(block_out_channels=kw["block_out_channels"], layers_per_block=2,
                      cross_attention_levels=kw["cross_levels"], attention_head_dim=8,
                      cross_attention_dim=32, norm_groups=8, temporal_conv_layers=4,
                      temporal_style="diffusers", dtype="float32")
        cfg, jcfg = UNet3DConfig(**common), JUNet3DConfig(**common)
    return kw, cfg, jcfg


@pytest.mark.parametrize("name", sorted(UNETS))
def test_unet_tree_equals_reference_and_runs_like_torch_ref(name):
    from tests.torch_ref import UNet3DConditionModelRef

    kw, cfg, jcfg = _unet_configs(name)
    ref = _randomize(UNet3DConditionModelRef(**kw).eval(), seed=3)
    sd = _sd_numpy(ref)
    tree = convert.convert_unet3d(sd, cfg)
    assert_trees_equal(tree, jconvert.convert_unet3d(sd, jcfg))

    unet = load_jax_params(UNet3D(cfg).eval(), tree)
    rng = np.random.default_rng(0)
    frames = 24 if name == "xl_structure" else 3
    lat = rng.normal(0, 1, (1, frames, 8, 8, 4)).astype(np.float32)
    ehs = rng.normal(0, 1, (1, 5, kw["cross_dim"])).astype(np.float32)
    ts = np.array([801], np.int32)
    with torch.no_grad():
        want = ref(torch.from_numpy(lat.transpose(0, 4, 1, 2, 3)), torch.from_numpy(ts),
                   torch.from_numpy(ehs))
        got = unet(torch.from_numpy(lat), torch.from_numpy(ts), torch.from_numpy(ehs))
    np.testing.assert_allclose(got.numpy().transpose(0, 4, 1, 2, 3), want.numpy(),
                               atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_unet_converter_is_strict(package):
    from tests.torch_ref import UNet3DConditionModelRef

    kw, cfg, jcfg = _unet_configs("tiny")
    conv, c = (convert, cfg) if package == "port" else (jconvert, jcfg)
    sd = _sd_numpy(UNet3DConditionModelRef(**kw))
    sd["down_blocks.0.bogus.weight"] = np.zeros((1,), np.float32)
    with pytest.raises(ValueError, match="unconverted"):
        conv.convert_unet3d(sd, c)
    sd.pop("down_blocks.0.bogus.weight")
    sd.pop("conv_in.weight")
    with pytest.raises(KeyError, match="conv_in"):
        conv.convert_unet3d(sd, c)


# --- CLIP towers ----------------------------------------------------------------------


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_text_tree_equals_reference_and_runs_like_transformers(act):
    from dvdx_tpu.models.text_encoder import TextEncoderConfig as JTextConfig
    from transformers import CLIPTextConfig, CLIPTextModel

    torch.manual_seed(0)
    hf = CLIPTextModel(CLIPTextConfig(
        vocab_size=99, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=16, hidden_act=act,
        bos_token_id=0, eos_token_id=98, pad_token_id=1)).eval()
    fields = dict(vocab_size=99, hidden_size=32, num_layers=2, num_heads=4,
                  intermediate_size=64, max_length=16, hidden_act=act,
                  layer_norm_eps=hf.config.layer_norm_eps, eos_token_id=98, dtype="float32")
    cfg = TextEncoderConfig(**fields)
    sd = _sd_numpy(hf)
    tree = convert.convert_text_encoder(sd, cfg)
    assert_trees_equal(tree, jconvert.convert_text_encoder(sd, JTextConfig(**fields)))
    enc = load_jax_params(CLIPTextEncoder(cfg).eval(), tree)
    ids = torch.tensor([[0, 5, 9, 42, 98, 1, 1, 1], [0, 7, 98, 1, 1, 1, 1, 1]])
    with torch.no_grad():
        want = hf(ids)
        hidden, pooled = enc(ids)
    np.testing.assert_allclose(hidden.numpy(), want.last_hidden_state.numpy(),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(pooled.numpy(), want.pooler_output.numpy(),
                               atol=2e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def clip_ckpt(tmp_path_factory):
    """A transformers CLIPModel checkpoint directory (quick_gelu towers, the
    BPE tokenizer), as ``tests/test_clip_scorer_convert.py`` builds it."""
    from transformers import CLIPConfig, CLIPModel, CLIPTextConfig, CLIPVisionConfig

    from dvdx_tpu_torch.models.tokenizer import build_test_vocab, write_tokenizer_files

    root = str(tmp_path_factory.mktemp("clip"))
    vocab, merges = build_test_vocab(["a", "photo", "of", "cat", "dog", "red"])
    write_tokenizer_files(os.path.join(root, "tokenizer"), vocab, merges)
    v = len(vocab)
    cfg = CLIPConfig(
        projection_dim=24,
        text_config=CLIPTextConfig(
            vocab_size=v, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=16, hidden_act="quick_gelu",
            bos_token_id=v - 2, eos_token_id=v - 1, pad_token_id=v - 1).to_dict(),
        vision_config=CLIPVisionConfig(
            image_size=32, patch_size=8, hidden_size=48, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4, hidden_act="quick_gelu").to_dict())
    torch.manual_seed(1)
    model = CLIPModel(cfg).eval()
    sd = {k: v.detach().float() for k, v in model.state_dict().items()
          if "position_ids" not in k}
    convert.write_safetensors(os.path.join(root, "model.safetensors"), sd)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(cfg.to_dict(), f)
    return root, model


def test_clip_vision_tree_equals_reference(clip_ckpt):
    root, model = clip_ckpt
    sd = {k: v for k, v in convert.load_state_dict(root).items()
          if k.startswith("vision_model.") or k.startswith("visual_projection")}
    cfg = VisionConfig(image_size=32, patch_size=8, hidden_size=48, num_layers=2,
                       num_heads=4, intermediate_size=96, projection_dim=24,
                       hidden_act="quick_gelu", layer_norm_eps=1e-5)
    tree = convert.convert_clip_vision(sd, cfg)
    assert_trees_equal(tree, jconvert.convert_clip_vision(sd, cfg))
    with pytest.raises(ValueError, match="unconverted"):
        convert.convert_clip_vision({**sd, "vision_model.extra": np.zeros(1, np.float32)}, cfg)
    tower = load_jax_params(CLIPVisionEncoder(cfg).eval(), tree)
    pixel = np.random.default_rng(0).normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        want = model.get_image_features(torch.from_numpy(pixel.transpose(0, 3, 1, 2)))
        got = tower(torch.from_numpy(pixel))
    want = getattr(want, "pooler_output", want)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5, rtol=1e-4)


def test_clip_scorer_matches_reference(clip_ckpt):
    """``load_clip_scorer`` in both packages: the same per-frame cosines
    (1e-5, float32) through the BPE tokenizer and the CLIP normalisation."""
    root, _ = clip_ckpt
    ours = convert.load_clip_scorer(root, device="cpu")
    ref = jconvert.load_clip_scorer(root)
    assert ours.preprocess == "clip" and ours.tokenizer is not None
    frames = np.random.default_rng(1).integers(0, 255, (3, 32, 32, 3), dtype=np.uint8)
    np.testing.assert_allclose(ours.frame_scores(frames, "a photo of dog"),
                               ref.frame_scores(frames, "a photo of dog"), atol=1e-5)
    assert abs(ours.score_video(frames, "a red cat")
               - ref.score_video(frames, "a red cat")) <= 1e-5


# --- VAE decoder ------------------------------------------------------------------


def test_vae_tree_equals_reference_and_decodes_like_torch_ref():
    from dvdx_tpu.models.vae import VAEConfig as JVAEConfig
    from tests.torch_ref import AutoencoderKLRef

    ref = _randomize(AutoencoderKLRef(latent_ch=4, block_out_channels=(16, 32),
                                      layers_per_block=1, groups=4,
                                      mid_attention=True).eval(), seed=5)
    fields = dict(latent_channels=4, base_channels=16, channel_mults=(1, 2),
                  layers_per_block=1, norm_groups=4, use_mid_attention=True,
                  final_tanh=False, dtype="float32")
    cfg = VAEConfig(**fields)
    sd = _sd_numpy(ref)
    tree = convert.convert_vae_decoder(sd, cfg)
    assert_trees_equal(tree, jconvert.convert_vae_decoder(sd, JVAEConfig(**fields)))
    with pytest.raises(KeyError, match="post_quant_conv"):
        convert.convert_vae_decoder({k: v for k, v in sd.items()
                                     if not k.startswith("post_quant_conv")}, cfg)
    dec = load_jax_params(VAEDecoder(cfg).eval(), tree)
    z = np.random.default_rng(1).normal(0, 1, (2, 4, 4, 4)).astype(np.float32)
    with torch.no_grad():
        want = ref.decode(torch.from_numpy(z.transpose(0, 3, 1, 2)))
        got = dec(torch.from_numpy(z * cfg.scaling_factor))
    np.testing.assert_allclose(got.numpy().transpose(0, 3, 1, 2), want.numpy(),
                               atol=5e-4, rtol=1e-3)
