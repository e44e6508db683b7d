"""Port vs reference: counter-based base noise and the DDIM schedule/step.

The validator re-derives z_0 from the seed: the random bits and the uniforms
are compared for equality; the float32 normals within 3 ulps (the port
evaluates XLA's erf_inv polynomial with XLA's fused multiply-adds, but XLA's
float32 log1p is not correctly rounded). Rounded to the bfloat16 latent, the
two agree bit for bit at most seeds, not all: an f32 difference can cross a
bf16 rounding boundary (seed 148 at the standard geometry, below), by one
bf16 ulp, which the validator's cross-platform tolerance absorbs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvdx_tpu.ops import rng as jrng
from dvdx_tpu.ops import scheduler as jsched
from dvdx_tpu_torch.ops import rng as trng
from dvdx_tpu_torch.ops import scheduler as tsched

torch.set_num_threads(2)

SEEDS = [0, 7, 123456789, 2**63 + 12345]


def _key_words(key) -> list:
    return [int(w) for w in np.asarray(jax.random.key_data(key))]


@pytest.mark.parametrize("seed", SEEDS)
def test_base_key_and_fold_in_equal(seed):
    jk = jrng.base_key(seed)
    tk = trng.base_key(seed)
    assert tk.tolist() == _key_words(jk)
    for frame in (0, 1, 15):
        assert trng.fold_in(tk, frame).tolist() == _key_words(
            jax.random.fold_in(jk, jnp.uint32(frame)))


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_random_bits_and_uniforms_equal(seed):
    key = jax.random.fold_in(jrng.base_key(seed), jnp.uint32(3))
    shape = (5, 9, 4)
    want_bits = np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64)
    got_bits = trng.random_bits(torch.tensor(_key_words(key)), shape, device="cpu").numpy()
    np.testing.assert_array_equal(got_bits, want_bits)
    want_u = np.asarray(jax.random.uniform(key, shape, jnp.float32,
                                           minval=np.nextafter(np.float32(-1), np.float32(0)),
                                           maxval=1.0))
    got_u = trng.uniform_from_bits(torch.from_numpy(got_bits)).numpy()
    np.testing.assert_array_equal(got_u.view(np.int32), want_u.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_video_noise_matches_reference(seed):
    """The base latent at (F, h, w, C) = (4, 10, 18, 4). The float32 normals
    may differ by up to 3 ulps: XLA's CPU log1p (inside erf_inv) is not
    correctly rounded and the port takes log1p in float64 (about 1% of values
    differ; ROADMAP section 3). The latent the pipeline uses is bfloat16, and
    at these seeds the two agree bit for bit there (not at every seed: see
    test_bf16_base_latent_differs_by_one_ulp_at_most)."""
    want = np.asarray(jrng.video_noise(jrng.base_key(seed), 4, (10, 18, 4)))
    got = trng.video_noise(trng.base_key(seed), 4, (10, 18, 4), device="cpu").numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    print(f"parity: {int((ulps > 0).sum())} of {ulps.size} normals differ, by up "
          f"to {ulps.max()} ulp")  # shown by pytest -rP
    assert ulps.max() <= 3, f"{int((ulps > 0).sum())} normals off, by up to {ulps.max()} ulp"
    want16 = np.asarray(jnp.asarray(want, jnp.bfloat16)).view(np.int16)
    got16 = torch.from_numpy(got).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(got16, want16)


def test_bf16_base_latent_differs_by_one_ulp_at_most():
    """Seed 148 at the standard latent geometry (16, 40, 72, 4) is one of the
    seeds (7 of 0-599) whose bfloat16 z_0 differs from the reference's: an
    f32 normal a few ulps off crosses a bf16 rounding boundary. Every
    differing element is exactly one bf16 ulp away, and the port's
    compare_arrays in the validator's cross-platform regime (atol 5e-2)
    accepts the port's z_0 against the reference's."""
    from dvdx_tpu_torch.verify.spotcheck import compare_arrays

    seed, shape = 148, (40, 72, 4)
    want = jax.jit(lambda k: jrng.video_noise(k, 16, shape))(jrng.base_key(seed))
    want16 = np.asarray(jnp.asarray(want, jnp.bfloat16))
    got16 = trng.video_noise(trng.base_key(seed), 16, shape, device="cpu").bfloat16()
    bits = np.abs(got16.view(torch.int16).numpy().astype(np.int64)
                  - want16.view(np.int16).astype(np.int64))
    print(f"parity: {int((bits > 0).sum())} of {bits.size} bf16 values differ, "
          f"by {bits.max()} ulp")  # shown by pytest -rP
    assert bits.max() == 1
    ok, err, bitwise = compare_arrays(got16, want16, bitwise=False, atol=5e-2)
    assert ok and not bitwise and 0 < err < 5e-2


@pytest.mark.parametrize("num_steps", [3, 25, 50])
def test_ddim_tables_equal(num_steps):
    want = jsched.make_ddim_schedule(num_steps)
    got = tsched.make_ddim_schedule(num_steps)
    np.testing.assert_array_equal(got.timesteps, np.asarray(want.timesteps))
    np.testing.assert_array_equal(got.alphas_cumprod, np.asarray(want.alphas_cumprod))
    np.testing.assert_array_equal(got.alphas_cumprod_prev,
                                  np.asarray(want.alphas_cumprod_prev))
    np.testing.assert_array_equal(tsched.make_betas(), jsched.make_betas())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ddim_step_matches_reference(dtype):
    """Every step of the 25-step schedule on the same (z, eps). The port
    fuses the multiply-adds XLA fuses, so the steps are bit-equal except
    where XLA's rsqrt of alpha is not correctly rounded (one table entry of
    25). There x0 moves by one float32 ulp, and the result by a few ulps of
    the largest term (atol 2^-21 * max|z|, the sum cancels, so no rtol);
    in bfloat16 such a difference can flip one rounding (one bf16 ulp,
    2^-8 relative)."""
    sched_j = jsched.make_ddim_schedule(25)
    sched_t = tsched.make_ddim_schedule(25)
    rng = np.random.default_rng(0)
    z = rng.normal(size=(1, 4, 6, 6, 4)).astype(np.float32)
    e = rng.normal(size=z.shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    step = jax.jit(lambda zz, ee, i: jsched.ddim_step(sched_j, i, zz, ee))
    exact = 0
    for i in range(25):
        want = np.asarray(step(jnp.asarray(z, jdt), jnp.asarray(e, jdt), i)
                          .astype(jnp.float32))
        got = tsched.ddim_step(sched_t, i, torch.from_numpy(z).to(tdt),
                               torch.from_numpy(e).to(tdt)).float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2 ** -21 * np.abs(want).max())
        else:
            np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)
        exact += int(np.array_equal(got, want))
    assert exact >= 24


def test_ddim_step_from_timestep():
    sched = tsched.make_ddim_schedule(25)
    z = torch.randn(2, 3, generator=torch.Generator().manual_seed(0))
    e = torch.randn(2, 3, generator=torch.Generator().manual_seed(1))
    t = int(sched.timesteps[7])
    assert torch.equal(tsched.ddim_step_from_timestep(sched, t, z, e),
                       tsched.ddim_step(sched, 7, z, e))
    with pytest.raises(ValueError):
        tsched.ddim_step_from_timestep(sched, 999, z, e)
