"""The cogvideox family: its plain reference against the program's plain path
at ``cogvideox-tiny-hf`` widths on the CPU (the same draw through the
program's converters and through the reference's own modules), the
reference's sampler against the program's, and on a card the control of
the cell ``cogvideox.mine`` on three seeds (``python -m pytest
portbench/tests/test_portbench_cogvideox.py -q -m cuda``)."""

import json
import os
import time

import pytest
import torch

from portbench import weights
from portbench.families import cogvideox
from portbench.harness import cell_limits
from portbench.reference.clip_text import tokenize
from portbench.tests.conftest import HERE, ROOT

SEEDS = (2147483911, 2147483912, 2147483913)


def _rel(a, b):
    return float((a.double() - b.double()).pow(2).mean().sqrt() / b.double().pow(2).mean().sqrt())


@pytest.fixture(scope="module")
def tiny_cog():
    with open(os.path.join(HERE, "tiny_cogvideox.json")) as f:
        cfg = json.load(f)
    return cfg, weights.build_pipeline(cfg, 12, "cpu"), weights.build_reference(cfg, 12, "cpu")


def test_transformer_text_and_decoder_match(tiny_cog):
    cfg, pipe, ref = tiny_cog
    gen = torch.Generator().manual_seed(0)
    z = torch.randn(1, 2, 8, 12, 16, generator=gen)
    ids = torch.from_numpy(tokenize(["", "a red ball"], 1024, 7))
    with torch.inference_mode():
        hidden = pipe.text_encoder(ids)[0]
        assert _rel(hidden, ref.text(ids)) < 1e-5
        for t in (999, 19):
            got = pipe.unet(z, torch.tensor([t]), hidden[1:2]).float()
            assert _rel(got, cogvideox.denoise(ref, z, t, hidden[1:2], "cpu")) < 1e-5
        # float32 against float32 in another summation order: the decoded
        # frame's RMS is about 0.1 here, so its rounding reads 1.2e-5 of it
        frame = pipe.vae_decoder(z[0, :1]).float()
        assert _rel(frame, cogvideox.decode(ref, z[0, :1], cfg, "cpu")) < 5e-5


def test_ddim_matches_the_program_to_bf16_rounding():
    from dvdx_tpu_torch.models.zoo import get_model_spec
    from dvdx_tpu_torch.ops.scheduler import ddim_step

    sched = get_model_spec("cogvideox-5b-hf").ddim_schedule(50)
    gen = torch.Generator().manual_seed(1)
    z = torch.randn(1, 2, 8, 8, 16, generator=gen).bfloat16()
    v = torch.randn(z.shape, generator=gen).bfloat16()
    for i in (0, 25, 49):
        got = ddim_step(sched, i, z, v).float()
        want = cogvideox.update(50, int(sched.timesteps[i]), z.float(), v.float())
        assert float((got - want).abs().max()) <= 2 ** -8 * float(want.abs().max())


@pytest.mark.cuda
def test_control_fails_and_program_passes(bench):
    """``cogvideox.mine`` at its own size on three seeds, with the float8
    reference read in the program's place after the window: the program
    correct, the control not, by the same limits and verdict."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.harness import run_cell

    cell = next(w for w in bench["workloads"] if w["name"] == "cogvideox.mine")
    limits = cell_limits(cell)
    for seed in SEEDS:
        out = run_cell(bench, cell, seed, 51.0, False, "cuda",
                       time.perf_counter(), root=ROOT, control=True, log=lambda s: None)
        assert out["failed"] == 0 and "step_s" in out["metrics"], out
        assert out["correct"], out["checks"]
        assert out["control_correct"] is False, (out["readings"], limits)
