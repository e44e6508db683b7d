"""Port vs reference: flash attention and frame-axis (temporal) attention.

The port's plain versions (what its kernels are held to on the card) are
compared with the reference's Pallas kernels run through the Pallas
interpreter and with the reference's einsum math, on the same numpy-seeded
inputs. The CUDA kernels are held to these plain versions on the card by
``tests/test_torch_cuda_kernels.py``.

Tolerances. float32: both sides compute the same formula in float32 and
differ only in summation order (1e-5). bfloat16: the reference's flash
kernel rounds q * scale to bf16 and rounds the unnormalised probabilities,
the plain version rounds the normalised ones; each such rounding is half a
bf16 ulp (2^-9 relative), so a few ulps of the output's scale are allowed
(4 * 2^-8 * max|ref|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvdx_tpu.ops.attention import _xla_attention
from dvdx_tpu.ops.pallas import flash_attention as jflash
from dvdx_tpu.ops.pallas import temporal_attention as jtemp
from dvdx_tpu_torch.ops import attention as tattn
from dvdx_tpu_torch.ops.kernels import flash_attention as tflash
from dvdx_tpu_torch.ops.kernels import temporal_attention as ttemp

torch.set_num_threads(2)

DTYPES = ["float32", "bfloat16"]


def _inputs(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _jax(xs, dtype):
    return [jnp.asarray(x, getattr(jnp, dtype)) for x in xs]


def _torch(xs, dtype, device="cpu"):
    return [torch.from_numpy(x).to(device=device, dtype=getattr(torch, dtype)) for x in xs]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _check(got, want, dtype):
    got, want = _f32(got), _f32(want)
    atol = 1e-5 if dtype == "float32" else 4 * 2 ** -8 * np.abs(want).max()
    print(f"parity: max_abs_err {np.abs(got - want).max():.3g}, max_abs_ref "
          f"{np.abs(want).max():.3g}, atol {atol:.3g}")  # shown by pytest -rP
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# --- flash attention (row 1) ------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,h,d", [(2, 40, 3, 64), (1, 77, 2, 40), (1, 128, 2, 16)])
def test_flash_plain_matches_pallas_and_xla(dtype, b, s, h, d):
    """S=40 and 77 leave a ragged key tail in the Pallas blocks (masked);
    D=40 is transformer_in's head width, D=64 the UNet's."""
    xs = _inputs((b, s, h, d), seed=s + d)
    q, k, v = _jax(xs, dtype)
    got = tflash.flash_attention(*_torch(xs, dtype))
    _check(got, jflash.flash_attention(q, k, v, interpret=True), dtype)
    _check(got, _xla_attention(q, k, v, d ** -0.5), dtype)


def test_attention_dispatch():
    """Self-attention with S >= 512 and a head dim the kernel takes goes to
    the flash wrapper; cross-attention, short S and the VAE's D=512 do not."""
    assert tattn.wants_flash(2880, 2880, 64) and tattn.wants_flash(720, 720, 64)
    assert not tattn.wants_flash(2880, 77, 64)
    assert not tattn.wants_flash(256, 256, 64)
    assert not tattn.wants_flash(2880, 2880, 512)
    xs = _inputs((1, 520, 1, 8), seed=1)
    q, k, v = _torch(xs, "float32")
    torch.testing.assert_close(tattn.multi_head_attention(q, k, v),
                               tflash.flash_attention_plain(q, k, v, 8 ** -0.5))


# --- frame-axis attention (rows 3, 4, 5) -------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,f,n,heads,d", [(2, 4, 13, 2, 40), (1, 8, 9, 3, 64)])
def test_temporal_plain_matches_pallas_frame_major(dtype, b, f, n, heads, d):
    """Frame-major (B, F, N, H*D): the fm kernel (row 4), the in-VMEM
    repack kernel (row 5) and the einsum reference; N=13 and 9 leave a
    ragged position tail in the Pallas blocks."""
    xs = _inputs((b, f, n, heads * d), seed=n)
    q, k, v = _jax(xs, dtype)
    got = ttemp.temporal_attention(*_torch(xs, dtype), heads=heads)
    _check(got, jtemp.temporal_attention_fm(q, k, v, heads=heads, interpret=True), dtype)
    _check(got, jtemp.temporal_attention(q, k, v, heads=heads, interpret=True), dtype)
    _check(got, jtemp.temporal_attention_reference(q, k, v, heads=heads), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads,d", [(2, 40), (3, 64)])
def test_temporal_plain_matches_pallas_position_major(dtype, heads, d):
    """Position-major (B, N, F, H*D) against row 3's kernel (needs F % 8 == 0)."""
    xs = _inputs((2, 11, 8, heads * d), seed=d)
    q, k, v = _jax(xs, dtype)
    got = ttemp.temporal_attention_posmajor(*_torch(xs, dtype), heads=heads)
    _check(got, jtemp.temporal_attention_posmajor(q, k, v, heads=heads,
                                                  interpret=True), dtype)
    _check(got, jtemp.temporal_attention_posmajor_reference(q, k, v, heads=heads), dtype)
