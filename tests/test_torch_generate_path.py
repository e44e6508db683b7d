"""The README's generate path on the port, against the JAX package: a
diffusers checkpoint directory loaded by both packages, the segmented runner,
the CCI context and step ranges, frame positions, spatially tiled decode,
``StepEngine.generate_recorded`` in segments, and the command line on the
CPU.

Tolerances. Within the port, the segmented runner and segmented recording are
the same step program as ``generate_core``, so they must be bit-identical.
Against the JAX package (float32 models): one UNet step in float32 within
1e-4 absolute (XLA and ATen sum in other orders); a whole generation with
bf16 latents within 0.125 absolute on z and eps and 2 uint8 levels on the
frames, as ``tests/test_torch_pipeline.py`` explains (a 1e-6 difference can
flip one bf16 rounding, which the DDIM chain carries on); the tiled decode
within 1e-5.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvdx_tpu.models import vae as jvae
from dvdx_tpu.ops import rng as jrng
from dvdx_tpu.pipelines import text2video as jt2v
from dvdx_tpu.utils import convert as jconvert
from dvdx_tpu.utils.init import fast_init
from dvdx_tpu_torch.models import vae as tvae
from dvdx_tpu_torch.ops import rng as trng
from dvdx_tpu_torch.ops.scheduler import make_ddim_schedule
from dvdx_tpu_torch.pipelines.text2video import (build_pipeline, build_segmented_runner,
                                                 cfg_denoise_step, denoise, generate,
                                                 generate_core, resolve_pipeline)
from dvdx_tpu_torch.utils import convert
from dvdx_tpu_torch.utils.bridge import load_jax_params, load_pipeline_params
from dvdx_tpu_torch.utils.video_io import decode_video
from dvdx_tpu_torch.verify.spotcheck import StepEngine

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN = dict(seed=3, num_frames=2, height=16, width=16, num_steps=3)


def _f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _randomize(module, seed, scale=0.05):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * scale)
    return module


@pytest.fixture(scope="module")
def fake_ckpt(tmp_path_factory):
    """A diffusers checkpoint directory in the layout of
    ``tests/test_convert.py``'s, float32: the UNet and the text tower as safetensors
    (written by the port's writer), the VAE as a ``.bin``, the BPE tokenizer
    with the text config's BOS / EOS ids set to its own."""
    from transformers import CLIPTextConfig, CLIPTextModel

    from dvdx_tpu_torch.models.tokenizer import build_test_vocab, write_tokenizer_files
    from tests.torch_ref import AutoencoderKLRef, UNet3DConditionModelRef

    root = str(tmp_path_factory.mktemp("ckpt"))

    def config(sub, cfg):
        os.makedirs(f"{root}/{sub}", exist_ok=True)
        with open(f"{root}/{sub}/config.json", "w") as f:
            json.dump(cfg, f)

    unet = _randomize(UNet3DConditionModelRef(
        block_out_channels=(32, 64), layers_per_block=1, cross_levels=(True, False),
        head_dim=16, cross_dim=64, groups=8, n_temp_convs=4), seed=11)
    config("unet", {"in_channels": 4, "out_channels": 4, "block_out_channels": [32, 64],
                    "layers_per_block": 1, "attention_head_dim": 16,
                    "cross_attention_dim": 64, "norm_num_groups": 8, "norm_eps": 1e-5,
                    "down_block_types": ["CrossAttnDownBlock3D", "DownBlock3D"]})
    convert.write_safetensors(f"{root}/unet/diffusion_pytorch_model.safetensors",
                              unet.state_dict())
    # the VAE keeps torch's default init, so its frames carry texture and
    # differ from frame to frame, as a validator's authenticity check wants
    torch.manual_seed(12)
    vae = AutoencoderKLRef(latent_ch=4, block_out_channels=(16, 32), layers_per_block=1,
                           groups=4, mid_attention=True)
    config("vae", {"latent_channels": 4, "block_out_channels": [16, 32],
                   "layers_per_block": 1, "norm_num_groups": 4, "scaling_factor": 0.18215})
    torch.save(vae.state_dict(), f"{root}/vae/diffusion_pytorch_model.bin")
    vocab, merges = build_test_vocab(["a", "red", "panda", "tree", "video", "of", "the"])
    write_tokenizer_files(f"{root}/tokenizer", vocab, merges)
    v = len(vocab)
    text_cfg = CLIPTextConfig(vocab_size=v, hidden_size=64, intermediate_size=128,
                              num_hidden_layers=2, num_attention_heads=4,
                              max_position_embeddings=16, hidden_act="gelu",
                              bos_token_id=v - 2, eos_token_id=v - 1, pad_token_id=v - 1)
    torch.manual_seed(0)
    text = CLIPTextModel(text_cfg).eval()
    config("text_encoder", text_cfg.to_dict())
    convert.write_safetensors(f"{root}/text_encoder/model.safetensors",
                              {k: t for k, t in text.state_dict().items()
                               if "position_ids" not in k})
    with open(f"{root}/model_index.json", "w") as f:
        json.dump({"_class_name": "TextToVideoSDPipeline"}, f)
    return root


@pytest.fixture(scope="module")
def ckpt_pipes(fake_ckpt):
    ours = resolve_pipeline(fake_ckpt, device="cpu")
    assert ours.spec.unet.dtype == "bfloat16"  # the default storage dtype
    ours = convert.load_diffusers_checkpoint(fake_ckpt, dtype="float32", device="cpu")
    return ours, jconvert.load_diffusers_checkpoint(fake_ckpt, dtype="float32")


def test_checkpoint_loads_as_in_reference(fake_ckpt, ckpt_pipes):
    ours, ref = ckpt_pipes
    for part in ("unet", "text", "vae"):
        got, want = getattr(ours.spec, part), getattr(ref.spec, part)
        for field in got.__dataclass_fields__:
            assert getattr(got, field) == getattr(want, field), (part, field)
    assert ours.spec.name == ref.spec.name and ours.spec.vae.final_tanh is False
    prompts = ["", "a red panda in a tree", "the video of the panda, 日本!"]
    np.testing.assert_array_equal(ours.tokenize(prompts), ref.tokenize(prompts))
    assert ours.tokenizer.eos_id == ours.spec.text.eos_token_id
    # the same weights as the reference's tree bridged into the port
    bridged = load_pipeline_params(build_pipeline(ours.spec, device="cpu"),
                                   jax.tree.map(np.asarray, ref.params))
    for (name, a), (_, b) in zip(ours.state_dict().items(), bridged.state_dict().items()):
        assert torch.equal(a, b), name


def test_checkpoint_generation_matches_reference(ckpt_pipes):
    ours, ref = ckpt_pipes
    vt, (zt, et, tt) = generate(ours, "a red panda in a tree", record=True, **GEN)
    vj, (zj, ej, tj) = jt2v.generate(ref, "a red panda in a tree", record=True, **GEN)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(_f32(zt[0]), _f32(zj[0]))
    print(f"checkpoint parity: z {np.abs(_f32(zt) - _f32(zj)).max():.3g}, eps "
          f"{np.abs(_f32(et) - _f32(ej)).max():.3g} (max |eps| {np.abs(_f32(ej)).max():.3g}),"
          f" frames {np.abs(vt.astype(int) - vj.astype(int)).max()} levels")
    np.testing.assert_allclose(_f32(zt), _f32(zj), atol=0.125, rtol=0)
    np.testing.assert_allclose(_f32(et), _f32(ej), atol=0.125, rtol=0)
    assert np.abs(vt.astype(int) - vj.astype(int)).max() <= 2 and vt.std() > 0


def test_fresh_reload_is_bitwise(fake_ckpt, ckpt_pipes):
    again = convert.load_diffusers_checkpoint(fake_ckpt, dtype="float32", device="cpu")
    v1, (z1, e1, _) = generate(ckpt_pipes[0], "a red panda", record=True, **GEN)
    v2, (z2, e2, _) = generate(again, "a red panda", record=True, **GEN)
    assert np.array_equal(v1, v2) and torch.equal(z1, z2) and torch.equal(e1, e2)


def test_convert_cli_writes_a_loadable_tree(fake_ckpt, ckpt_pipes, tmp_path, capsys):
    from dvdx_tpu_torch.utils.bridge import load_flat_npz

    out = str(tmp_path / "tree.npz")
    assert convert.main(["--src", fake_ckpt, "--out", out]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ours = ckpt_pipes[0]
    assert summary["tokenizer"] == "clip-bpe" and summary["out"] == out
    assert summary["unet_params"] == sum(p.numel() for p in ours.unet.parameters())
    loaded = load_pipeline_params(build_pipeline(ours.spec, device="cpu"), load_flat_npz(out))
    for (name, a), (_, b) in zip(ours.state_dict().items(), loaded.state_dict().items()):
        assert torch.equal(a, b), name


def test_chip_smoke_synthetic_checkpoint_loads_in_both_packages(tmp_path):
    """``chip_smoke.py``'s phase-7 writer at tiny widths: its text tower has
    transformers' CLIPTextModel keys and shapes, its UNet is stored in
    bfloat16, and both packages load the directory into the same weights and
    token ids."""
    import runpy

    from transformers import CLIPTextConfig, CLIPTextModel

    smoke = runpy.run_path(os.path.join(REPO, "chip_smoke.py"), run_name="chip_smoke")
    text = dict(hidden=32, layers=2, heads=4, inner=64, positions=77)
    sd = smoke["clip_text_state_dict"](50, gen=torch.Generator().manual_seed(0), device="cpu",
                                       **text)
    hf = CLIPTextModel(CLIPTextConfig(vocab_size=50, hidden_size=32, intermediate_size=64,
                                      num_hidden_layers=2, num_attention_heads=4,
                                      max_position_embeddings=77))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in hf.state_dict().items() if "position_ids" not in k}
    root = str(tmp_path / "ckpt")
    unet = dict(in_channels=4, out_channels=4, block_out_channels=(32, 64), layers_per_block=1,
                cross_levels=(True, False), head_dim=16, cross_dim=32, groups=8,
                n_temp_convs=4)
    vae = dict(latent_ch=4, block_out_channels=(16, 32), layers_per_block=1, groups=4,
               mid_attention=True)
    words = "a red panda rides a bicycle".split() * 3
    nbytes = smoke["write_synthetic_checkpoint"](root, unet, vae, text, words, "cpu")
    assert nbytes == sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root)
                         for f in fs if f.endswith(".safetensors"))
    ours = convert.load_diffusers_checkpoint(root, dtype="float32", device="cpu")
    ref = jconvert.load_diffusers_checkpoint(root, dtype="float32")
    w = ours.unet.conv_in.weight
    assert torch.equal(w, w.bfloat16().float())  # read from bfloat16
    bridged = load_pipeline_params(build_pipeline(ours.spec, device="cpu"),
                                   jax.tree.map(np.asarray, ref.params))
    for (name, a), (_, b) in zip(ours.state_dict().items(), bridged.state_dict().items()):
        assert torch.equal(a, b), name
    prompts = ["", "a red panda rides a bicycle through a snowy forest"]
    np.testing.assert_array_equal(ours.tokenize(prompts), ref.tokenize(prompts))


# --- the segmented runner and the step arguments ----------------------------------


@pytest.fixture(scope="module")
def bridged(tiny_hf_pipeline):
    port = build_pipeline("zeroscope-tiny-hf", device="cpu")
    return tiny_hf_pipeline, load_pipeline_params(port, jax.tree.map(np.asarray,
                                                                     tiny_hf_pipeline.params))


@pytest.mark.parametrize("cfg_split", [False, True])
def test_segmented_runner_is_generate_core(bridged, cfg_split):
    """Segments of 2 over 5 steps (the last one short) give generate_core's
    frames bit for bit."""
    _, port = bridged
    ids = torch.from_numpy(port.tokenize(["", "a segmented run"])).long()
    run = build_segmented_runner(port, num_frames=2, height=32, width=32, num_steps=5,
                                 segment_steps=2, cfg_split=cfg_split)
    with torch.inference_mode():
        want = generate_core(port, ids, trng.base_key(4), sched=make_ddim_schedule(5),
                             num_frames=2, height=32, width=32, guidance_scale=7.5,
                             cfg_split=cfg_split)
    got = run(ids, trng.base_key(4))
    assert got.shape == (2, 32, 32, 3) and torch.equal(got, want)


def test_segmented_runner_matches_reference(bridged):
    ref, port = bridged
    ids = port.tokenize(["", "a segmented run"])
    kw = dict(num_frames=2, height=32, width=32, num_steps=3, segment_steps=2)
    want = np.asarray(jt2v.build_segmented_runner(ref, **kw)(
        ref.params, jnp.asarray(ids), jrng.base_key(4)))
    got = build_segmented_runner(port, **kw)(torch.from_numpy(ids).long(), trng.base_key(4))
    to_u8 = lambda f: np.clip((f + 1.0) * 127.5, 0, 255).astype(np.uint8)  # noqa: E731
    assert np.abs(to_u8(got.numpy()).astype(int) - to_u8(want).astype(int)).max() <= 2


def test_context_weight_matches_reference(bridged):
    ref, port = bridged
    kw = dict(seed=5, num_frames=3, height=32, width=32, num_steps=3, record=True,
              context_weight=0.3)
    vt, (zt, et, _) = generate(port, "a coherent clip", **kw)
    vj, (zj, ej, _) = jt2v.generate(ref, "a coherent clip", **kw)
    plain, (_, e0, _) = generate(port, "a coherent clip", **{**kw, "context_weight": 0.0})
    assert not torch.equal(et, e0)  # the context reaches the UNet
    np.testing.assert_allclose(_f32(zt), _f32(zj), atol=0.125, rtol=0)
    np.testing.assert_allclose(_f32(et), _f32(ej), atol=0.125, rtol=0)
    assert np.abs(vt.astype(int) - vj.astype(int)).max() <= 2


def _step_inputs(port):
    hidden = port.text_encoder(torch.from_numpy(port.tokenize(["", "a step"])).long())[0]
    z = trng.video_noise(trng.base_key(9), 4, (16, 16, 4), device="cpu")[None]
    return z, hidden.detach()


def test_step_range_and_context_latent_match_reference(bridged):
    """Steps [1, 3) of a 4-step schedule from the same float32 z, with a
    context latent: z and eps within 1e-4."""
    ref, port = bridged
    z, hidden = _step_inputs(port)
    ctx = z.mean(dim=0, keepdim=True)
    with torch.inference_mode():
        zf, zs, es = denoise(port.unet, make_ddim_schedule(4), z, hidden[1:2], hidden[0:1],
                             7.5, context_latent=ctx, context_weight=0.5, record=True,
                             step_range=(1, 3))
    jsched = jt2v.make_ddim_schedule(4)
    h = jnp.asarray(hidden.numpy())
    jzf, jzs, jes = jax.jit(lambda p: jt2v.denoise(
        ref.unet.apply, p, jsched, jnp.asarray(z.numpy()), h[1:2], h[0:1], 7.5,
        context_latent=jnp.asarray(ctx.numpy()), context_weight=0.5, record=True,
        step_range=(1, 3)))(ref.params["unet"])
    assert zs.shape == (2, 1, 4, 16, 16, 4)
    for got, want in ((zf, jzf), (zs, jzs), (es, jes)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_frame_positions_match_reference(tiny_pipeline):
    """The rotary style with absolute frame positions: one float32 step
    within 1e-4, and the positions change the result."""
    port = load_pipeline_params(build_pipeline("zeroscope-tiny", device="cpu"),
                                jax.tree.map(np.asarray, tiny_pipeline.params))
    z, hidden = _step_inputs(port)
    pos = torch.tensor([3, 4, 5, 6], dtype=torch.int32)
    sched = make_ddim_schedule(4)
    with torch.inference_mode():
        zp, eps = cfg_denoise_step(port.unet, sched, z, 1, hidden[1:2], hidden[0:1], 7.5,
                                   frame_positions=pos)
        _, eps0 = cfg_denoise_step(port.unet, sched, z, 1, hidden[1:2], hidden[0:1], 7.5)
    h = jnp.asarray(hidden.numpy())
    jzp, jeps = jax.jit(lambda p: jt2v.cfg_denoise_step(
        tiny_pipeline.unet.apply, p, jt2v.make_ddim_schedule(4), jnp.asarray(z.numpy()), 1,
        h[1:2], h[0:1], 7.5, frame_positions=jnp.asarray(pos.numpy())))(
        tiny_pipeline.params["unet"])
    assert not torch.equal(eps, eps0)
    np.testing.assert_allclose(eps.numpy(), np.asarray(jeps), atol=1e-4, rtol=0)
    np.testing.assert_allclose(zp.numpy(), np.asarray(jzp), atol=1e-4, rtol=0)


# --- spatially tiled decode ----------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_vae():
    cfg = jvae.tiny_vae_config()
    jdec = jvae.VAEDecoder(cfg)
    params = fast_init(jdec, 0, jnp.zeros((1, 8, 8, 4), jnp.float32))
    dec = load_jax_params(tvae.VAEDecoder(tvae.tiny_vae_config()).eval(),
                          jax.tree.map(np.asarray, params))
    return jdec, params, dec


def test_tile_layout_matches_reference():
    for size, tile, stride in [(16, 8, 6), (17, 8, 6), (8, 8, 8), (20, 16, 12), (72, 48, 40)]:
        assert tvae._tile_starts(size, tile, stride) == jvae._tile_starts(size, tile, stride)
    for args in [(16, 0, 28, 4), (16, 12, 28, 4), (384, 320, 1024, 64), (8, 0, 8, 0)]:
        np.testing.assert_array_equal(tvae._blend_weight_1d(*args), jvae._blend_weight_1d(*args))


def test_tiled_decode_matches_reference(tiny_vae):
    jdec, params, dec = tiny_vae
    z = np.random.default_rng(1).normal(0, 1, (2, 16, 24, 4)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, z: jvae.decode_frames_tiled(
        jdec.apply, p, z, tile=8, overlap=4, upscale=2))(params, jnp.asarray(z)))
    with torch.inference_mode():
        got = tvae.decode_frames_tiled(dec, torch.from_numpy(z), tile=8, overlap=4)
        full = tvae.decode_frames_tiled(dec, torch.from_numpy(z))
        one = tvae.decode_frame_spatially_tiled(dec, torch.from_numpy(z[0]), tile=24,
                                                overlap=4)
    assert got.shape == (2, 32, 48, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert torch.equal(one, full[0])  # a single covering tile is the full decode
    assert not torch.equal(got, full)


# --- recording in segments ----------------------------------------------------------


def test_generate_recorded_leaves_do_not_depend_on_segments(bridged):
    _, port = bridged
    eng = StepEngine(port)
    kw = dict(seed=2, num_frames=2, height=32, width=32, num_steps=5, guidance_scale=7.5)
    runs = [eng.generate_recorded("a recorded run", segment_steps=s, cfg_split=True, **kw)
            for s in (1, 2, 5)]
    v, (zs, es, ts) = generate(port, "a recorded run", record=True, cfg_split=True,
                               **{k: kw[k] for k in kw if k != "guidance_scale"})
    for video, z, e, t in runs:
        assert np.array_equal(video, v) and np.array_equal(t, ts)
        assert torch.equal(z, zs[:, 0]) and torch.equal(e, es[:, 0])


# --- the command line -------------------------------------------------------------


def _cli(args, timeout=300):
    return subprocess.run([sys.executable, "-m", "dvdx_tpu_torch", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, "PYTHONPATH": REPO})


@pytest.mark.parametrize("source", ["registry", "checkpoint"])
def test_cli_generate_on_cpu_writes_video(source, fake_ckpt, tmp_path):
    out = tmp_path / "clip.mp4"
    model = "zeroscope-tiny" if source == "registry" else fake_ckpt
    r = _cli(["generate", "--prompt", "a red panda", "--model", model, "--device", "cpu",
              "--perturb", "--frames", "3", "--width", "16", "--height", "16", "--steps",
              "2", "--cfg-split", "--segment-steps", "1", "--out", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "device=cpu" in r.stdout
    assert decode_video(out.read_bytes()).shape == (3, 16, 16, 3)


def test_cli_help_and_no_card():
    r = _cli(["--help"], timeout=60)
    assert r.returncode == 0
    for cmd in ("generate", "miner", "validator", "convert", "mock-round", "strategy",
                "coordinator", "keys", "econ"):
        assert f"  {cmd} " in r.stdout
    assert _cli(["frobnicate"], timeout=60).returncode == 2
    if torch.cuda.is_available():
        pytest.skip("a card is present: generate would run on it")
    r = _cli(["generate", "--prompt", "x", "--model", "zeroscope-tiny"], timeout=60)
    assert r.returncode == 2 and "no CUDA device" in r.stderr
    r = _cli(["validator", "--model", "zeroscope-tiny"], timeout=60)
    assert r.returncode == 2 and "no CUDA device" in r.stderr
