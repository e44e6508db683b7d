"""The CogVideoX block's kernels against their plain versions on the card, at
the shapes of ``cogvideox.mine`` (13 x 480x720 latents: 226 text + 17,550
video = 17,776 joint tokens, batch 2 for the guidance pair, 48 heads of
64): ``qk_norm_rope`` (``ops/kernels/qk_norm_rope.py``) and the two
epilogues of ``ops/kernels/dit_epilogue.py``. Every case is marked ``cuda``
and skips where there is no CUDA card; on one:
``python -m pytest tests/test_torch_cogvideox_kernels.py -q -m cuda``.

Kernel and plain version both compute in float32 and round once to bf16, in
another order of operations: each output within one bf16 rounding step of
its value (a step is at most 2^-7 of the value; near zero 2^-7 of 2^-8 of
the largest output), and at least 99% of outputs the same bits (measured on
the card at these shapes: 0.99998 of qk_norm_rope's, the rest one step).
"""

import pytest
import torch

from dvdx_tpu_torch.models.cogvideox import CogVideoXConfig, rope_tables
from dvdx_tpu_torch.models.layers import LayerNorm
from dvdx_tpu_torch.ops.kernels import dit_epilogue as de
from dvdx_tpu_torch.ops.kernels import qk_norm_rope as qk

pytestmark = pytest.mark.cuda

B, T, S, H, D, C = 2, 226, 17776, 48, 64, 3072


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(shape, seed, device, scale=1.0, shift=0.0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device) * scale + shift


def _close(got, want):
    got, want = got.float(), want.float()
    tol = 2.0 ** -7 * torch.maximum(want.abs(), want.abs().max() * 2.0 ** -8)
    assert bool(((got - want).abs() <= tol).all()), float((got - want).abs().max())
    same = (got == want).float().mean().item()
    assert same >= 0.99, same


def test_qk_norm_rope_matches_plain(cuda):
    qkv = _randn((B, S, 3, H, D), 0, cuda, 2.0, 0.5).bfloat16()
    nq, nk = LayerNorm(D, eps=1e-6), LayerNorm(D, eps=1e-6)
    with torch.no_grad():
        for i, n in enumerate((nq, nk)):
            n.weight.copy_(_randn((D,), 1 + i, "cpu", 0.05, 1.0))
            n.bias.copy_(_randn((D,), 3 + i, "cpu", 0.05))
    nq, nk = nq.to(cuda).bfloat16(), nk.to(cuda).bfloat16()
    cos, sin = (t[:, None].to(cuda) for t in rope_tables(CogVideoXConfig(), 13, 30, 45))
    before = qk.LAUNCHES
    with torch.inference_mode():
        q, k = qk.qk_norm_rope(qkv[:, :, 0], qkv[:, :, 1], nq, nk, cos, sin, T)
        torch.cuda.synchronize()
        assert qk.LAUNCHES == before + 1
        for got, x, n in ((q, qkv[:, :, 0], nq), (k, qkv[:, :, 1], nk)):
            assert got.is_contiguous() and got.shape == (B, S, H, D)
            _close(got, qk.qk_norm_rope_plain(x, n.weight, n.bias, n.eps, cos, sin, T))


def test_bias_gelu_matches_plain(cuda):
    y = _randn((B, S, 4 * C), 5, cuda, 1.5).bfloat16()
    b = _randn((4 * C,), 6, cuda, 0.05).bfloat16()
    want = de.bias_gelu_plain(y.clone(), b)
    before = de.LAUNCHES
    with torch.inference_mode():
        got = de.bias_gelu_(y, b)
        torch.cuda.synchronize()
    assert de.LAUNCHES == before + 1 and got.data_ptr() == y.data_ptr()
    _close(got, want)


def test_gated_residual_matches_plain(cuda):
    x = _randn((B, S, C), 7, cuda, 4.0).bfloat16()
    y = _randn((B, S, C), 8, cuda).bfloat16()
    b = _randn((C,), 9, cuda, 0.05).bfloat16()
    emb6 = _randn((B, 1, 6 * C), 10, cuda, 0.5).bfloat16()
    gate, enc_gate = emb6[..., 2 * C:3 * C], emb6[..., 5 * C:]
    want = de.gated_residual_plain(x.clone(), y, b, gate, enc_gate, T)
    before = de.GATED_LAUNCHES
    with torch.inference_mode():
        got = de.gated_residual_(x, y, b, gate, enc_gate, T)
        torch.cuda.synchronize()
    assert de.GATED_LAUNCHES == before + 1 and got.data_ptr() == x.data_ptr()
    _close(got, want)


def test_card_tensors_the_gates_refuse_raise(cuda):
    """On the card no plain pass runs unseen: float32 tensors, another head
    size or a misaligned gate raise, and no kernel launches."""
    x = _randn((1, 40, 64), 11, cuda)
    b = _randn((64,), 12, cuda)
    emb6 = _randn((1, 1, 7 * 64), 13, cuda).bfloat16()
    counts = (de.LAUNCHES, de.GATED_LAUNCHES, qk.LAUNCHES)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="bias_gelu_"):
            de.bias_gelu_(x.clone(), b)
        with pytest.raises(ValueError, match="gated_residual_"):
            de.gated_residual_(x.bfloat16(), x.bfloat16(), b.bfloat16(), emb6[..., 64:128],
                               emb6[..., 321:385], 3)
        n = LayerNorm(32, eps=1e-6).to(cuda).bfloat16()
        q = _randn((1, 40, 2, 32), 14, cuda).bfloat16()
        cos = torch.ones(37, 1, 32, device=cuda)
        with pytest.raises(ValueError, match="qk_norm_rope"):
            qk.qk_norm_rope(q, q, n, n, cos, cos, 3)
    assert (de.LAUNCHES, de.GATED_LAUNCHES, qk.LAUNCHES) == counts
