"""The plain reference against the program's plain path at
``zeroscope-tiny-hf`` widths on the CPU: the same draw through the
program's converter and through the reference's own modules."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import check, weights
from portbench.families import unet3d
from portbench.reference import merkle, noise
from portbench.reference.clip_text import tokenize
from portbench.reference.torch_ref import DDIMSchedulerRef
from portbench.tests.conftest import HERE


@pytest.fixture(scope="module")
def tiny():
    with open(os.path.join(HERE, "tiny.json")) as f:
        cfg = json.load(f)
    return cfg, weights.build_pipeline(cfg, 11, "cpu"), weights.build_reference(cfg, 11, "cpu")


def _rel(a, b):
    return float((a.double() - b.double()).pow(2).mean().sqrt() / b.double().pow(2).mean().sqrt())


def test_unet_text_and_decoder_match(tiny):
    cfg, pipe, ref = tiny
    gen = torch.Generator().manual_seed(0)
    z = torch.randn(1, 4, 16, 16, 4, generator=gen)
    ids = torch.from_numpy(tokenize(["", "a red ball"], 1024, 16))
    with torch.inference_mode():
        hidden = pipe.text_encoder(ids)[0]
        assert _rel(hidden, ref.text(ids)) < 1e-5
        for t in (961, 1):
            got = pipe.unet(z, torch.tensor([t]), hidden[1:2]).float()
            want = unet3d.denoise(ref, z, t, hidden[1:2], "cpu")
            assert _rel(got, want) < 1e-5
        frame = pipe.vae_decoder(z[0, :1]).float()
        want = unet3d.decode(ref, z[0, :1], cfg, "cpu")
        assert _rel(frame, want) < 1e-5


def test_tokenizer_matches_the_program(tiny):
    _, pipe, _ = tiny
    prompts = ["A red panda, riding a bicycle!", ""]
    assert np.array_equal(pipe.tokenize(prompts), tokenize(prompts, 1024, 16))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 33 + 5, 3_000_000_000])
def test_noise_bit_equal_to_the_program(seed):
    from dvdx_tpu_torch.ops import rng

    want = rng.video_noise(rng.base_key(seed), 3, (8, 12, 4), device="cpu").numpy()
    assert np.array_equal(noise.video_noise(seed, 3, (8, 12, 4)), want)


def test_ddim_matches_the_program_to_bf16_rounding():
    from dvdx_tpu_torch.ops.scheduler import ddim_step, make_ddim_schedule

    sched, ref = make_ddim_schedule(25), DDIMSchedulerRef()
    ref.set_timesteps(25)
    gen = torch.Generator().manual_seed(1)
    z = torch.randn(1, 4, 8, 8, 4, generator=gen).bfloat16()
    eps = torch.randn(z.shape, generator=gen).bfloat16()
    for i in (0, 12, 24):
        got = ddim_step(sched, i, z, eps).float()
        want = ref.step(eps.float(), int(sched.timesteps[i]), z.float())
        assert float((got - want).abs().max()) <= 2 ** -8 * float(want.abs().max())


def test_merkle_root_and_paths_match_the_program():
    from dvdx_tpu_torch.verify.merkle import MerkleCommitment

    gen = torch.Generator().manual_seed(2)
    zs = torch.randn(5, 2, 3, 4, 4, generator=gen).bfloat16()
    epss = torch.randn(5, 2, 3, 4, 4, generator=gen).bfloat16()
    ts = np.array([961, 721, 481, 241, 1])
    com = MerkleCommitment(ts, zs, epss)
    leaves = [merkle.leaf_hash(int(t), check._bf16_bytes(zs[i]), check._bf16_bytes(epss[i]))
              for i, t in enumerate(ts)]
    assert leaves == list(com.leaves) and merkle.root(leaves) == com.root
    for i in range(5):
        assert merkle.verify_path(leaves[i], com.proof(i), com.root)
        assert not merkle.verify_path(leaves[(i + 1) % 5], com.proof(i), com.root)
