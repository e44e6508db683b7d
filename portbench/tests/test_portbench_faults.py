"""The output check refuses a broken timed path: each fault a cell can have
is planted in the program under the probe, the rest of a run is driven on
the CPU at the tiny widths, and ``correct`` must come out false (and true
for the sound program). The faults: a denoise step that returns its state
unchanged; half of the CFG batch left out (the unconditional half replaced
by the conditional one, so the guidance averages over the rest); an answer
altered where it is produced (every UNet output perturbed by a tenth of its
spread). The exchange between chips is not a fault of these one-chip
cells."""

import pytest
import torch

from portbench.tests.conftest import run_tiny


def unchanged_state(monkeypatch):
    from dvdx_tpu_torch.pipelines import text2video

    monkeypatch.setattr(text2video, "ddim_step", lambda sched, i, z, eps: z)
    return None


def half_batch(monkeypatch):
    def fault(pipe):
        def keep_cond(mod, args, out):
            return torch.cat([out[1:], out[1:]]) if out.shape[0] == 2 else out
        pipe.unet.register_forward_hook(keep_cond)
    return fault


def altered_answer(monkeypatch):
    def fault(pipe):
        gen = torch.Generator().manual_seed(3)

        def perturb(mod, args, out):
            return out + 0.1 * out.float().std() * torch.randn(
                out.shape, generator=gen).to(out.dtype)
        pipe.unet.register_forward_hook(perturb)
    return fault


@pytest.mark.parametrize("traffic", ["mine", "audit"])
def test_sound_program_is_correct(traffic):
    out = run_tiny(traffic)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("traffic", ["mine", "audit"])
@pytest.mark.parametrize("make_fault", [unchanged_state, half_batch, altered_answer])
def test_fault_is_refused(traffic, make_fault, monkeypatch):
    out = run_tiny(traffic, fault=make_fault(monkeypatch))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("traffic", ["mine", "audit"])
def test_the_control_is_refused_by_the_runs_own_verdict(traffic):
    out = run_tiny(traffic, control=True)
    assert out["correct"], out["checks"]
    assert out["control_correct"] is False, out["readings"]["control"]
