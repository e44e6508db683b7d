"""What the reference check of ``chip_smoke.py`` can see, measured on the CPU.

The check runs one batched UNet call of ``reference_check_pipeline`` on the
card (the kernels) and on the CPU (the plain versions), both bf16, and holds
them within ``REFERENCE_RELRMS_TOL`` (relative RMS of eps). Here, on the same
weights and inputs: the model's own bf16 spread (bf16 against float32) must
sit inside that tolerance, and a 3% fault in the output of GroupNorm or of
the fused temporal block must land outside it. The fused spatial tail, the
frame-axis attention and the feed-forward (which now run only in the mid
block, at 4x4 latents) and flash attention reach eps through 0.1-scale
output projections or a small share of the model: a 3% fault there moves
eps about as far as bf16 rounding does, so the check sees them only when
they are larger, and the per-kernel checks (2 bf16 ulps) are what hold
those kernels. Each distance is printed (``-rP``).
"""

import pytest
import torch

from dvdx_tpu_torch.models import layers
from dvdx_tpu_torch.ops import attention
from dvdx_tpu_torch.utils.testing import (REFERENCE_RELRMS_TOL, reference_check_inputs,
                                          reference_check_pipeline, relative_rms,
                                          unet_pair_call)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def reference():
    pipe = reference_check_pipeline()
    z, hidden, t = reference_check_inputs(pipe)
    return pipe, (z, hidden, t), unet_pair_call(pipe.unet, z, hidden, t)


def test_bf16_spread_is_inside_the_tolerance(reference):
    _, inputs, eps16 = reference
    eps32 = unet_pair_call(reference_check_pipeline("float32").unet, *inputs)
    spread = relative_rms(eps16, eps32)
    print(f"bf16 vs float32: relative RMS {spread:.5f} "
          f"(tolerance {REFERENCE_RELRMS_TOL})")
    assert spread < REFERENCE_RELRMS_TOL


@pytest.mark.parametrize("module,name,caught", [
    (layers, "group_norm_act", True), (layers, "temporal_attention", False),
    (layers, "geglu_ff", False), (attention, "flash_attention", False),
    (layers, "fused_spatial_tail", False), (layers, "fused_temporal_block", True)])
def test_three_percent_fault(reference, monkeypatch, module, name, caught):
    pipe, inputs, eps16 = reference
    kernel = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: kernel(*a, **k) * 1.03)
    dist = relative_rms(unet_pair_call(pipe.unet, *inputs), eps16)
    print(f"3% fault in {name}: relative RMS {dist:.5f} "
          f"(tolerance {REFERENCE_RELRMS_TOL})")
    assert dist > (REFERENCE_RELRMS_TOL if caught else 0.0)
