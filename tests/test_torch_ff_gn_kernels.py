"""Port vs reference: the fused GEGLU feed-forward and GroupNorm(+SiLU).

The port's plain versions are compared with the reference's Pallas kernels
(Pallas interpreter) and with the reference's unfused math, on the same
numpy-seeded inputs. The CUDA kernels are held to these plain versions on
the card by ``tests/test_torch_cuda_kernels.py``.

Tolerances. float32: same formula, other summation order (1e-5 relative to
the output's scale for the 8x-wide FF products). bfloat16: value, gate and
the gated product are each rounded to bf16 on both sides, but a one-ulp
difference in a rounded intermediate can move the output by about one bf16
ulp of its scale: 4 * 2^-8 * max|ref|.
"""

import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvdx_tpu.ops import groupnorm as jgn
from dvdx_tpu.ops.pallas import geglu_ff as jff
from dvdx_tpu_torch.ops import groupnorm as tgn
from dvdx_tpu_torch.ops.kernels import geglu_ff as tff
from dvdx_tpu_torch.ops.kernels.fused_math import geglu_residual

torch.set_num_threads(2)

DTYPES = ["float32", "bfloat16"]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jgn, "_INTERPRET", True)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _check(got, want, dtype, f32_tol=1e-5):
    got, want = _f32(got), _f32(want)
    scale = np.abs(want).max()
    atol = f32_tol * scale if dtype == "float32" else 4 * 2 ** -8 * scale
    print(f"parity: max_abs_err {np.abs(got - want).max():.3g}, max_abs_ref "
          f"{scale:.3g}, atol {atol:.3g}")  # shown by pytest -rP
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# --- GEGLU feed-forward (row 8) ----------------------------------------------

def _ff_params(t, c, seed):
    """x (t, C) and the reference's flax layout: w_in (C, 2I) [value, gate],
    w_out (I, C)."""
    rng = np.random.default_rng(seed)
    inner = 4 * c
    return (rng.normal(size=(t, c)).astype(np.float32),
            (rng.normal(size=(c, 2 * inner)) * c ** -0.5).astype(np.float32),
            (rng.normal(size=(2 * inner,)) * 0.1).astype(np.float32),
            (rng.normal(size=(inner, c)) * inner ** -0.5).astype(np.float32),
            (rng.normal(size=(c,)) * 0.1).astype(np.float32))


def _ff_torch(params, dtype, device="cpu"):
    x, w_in, b_in, w_out, b_out = params
    dt = getattr(torch, dtype)
    return [torch.from_numpy(a).to(device=device, dtype=dt)
            for a in (x, w_in.T.copy(), b_in, w_out.T.copy(), b_out)]


def _ff_unfused(x, w_in, b_in, w_out, b_out):
    """The reference's unfused GEGLUFeedForward branch (nn.Dense math)."""
    dt = x.dtype
    hg = jnp.dot(x, w_in.astype(dt)) + b_in.astype(dt)
    h, gate = jnp.split(hg, 2, axis=-1)
    h = h * nn.gelu(gate, approximate=False)
    return jnp.dot(h, w_out.astype(dt)) + b_out.astype(dt)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,c", [(50, 32), (37, 64)])
def test_geglu_plain_matches_pallas_and_unfused(dtype, t, c):
    """t=50 and 37 leave a ragged token tail in the Pallas blocks."""
    params = _ff_params(t, c, seed=t)
    jargs = [jnp.asarray(a, getattr(jnp, dtype)) for a in params]
    got = tff.geglu_ff(*_ff_torch(params, dtype))
    _check(got, jff.geglu_ff(*jargs, interpret=True), dtype)
    _check(got, _ff_unfused(*jargs), dtype)


def _geglu_one_expression(x, w_in, b_in, w_out, b_out):
    """The kernels' rounding points written as one expression: value and
    gate rounded, the gated product rounded, the output bias added in f32
    before the one rounding."""
    dt = x.dtype
    inner = w_in.shape[0] // 2
    hg = x.float() @ w_in.float().t() + b_in.float()
    val, gate = hg[:, :inner].to(dt).float(), hg[:, inner:].to(dt).float()
    h = (val * (0.5 * gate * (1.0 + torch.erf(gate * 2 ** -0.5)))).to(dt)
    return (h.float() @ w_out.float().t() + b_out.float()).to(dt)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,c", [(50, 32), (130, 64)])
def test_geglu_stage_plains_compose_to_geglu_ff(dtype, t, c):
    """The plain versions of the two kernel stages (geglu_in, then geglu_out)
    compose bit for bit to geglu_ff_plain and to the one-expression form,
    match the reference's Pallas kernel, and geglu_out's residual epilogue
    is bit for bit the fused kernels' plain GEGLU residual."""
    params = _ff_params(t, c, seed=t + 1)
    x, w_in, b_in, w_out, b_out = _ff_torch(params, dtype)
    h = tff.geglu_in(x, w_in, b_in)  # CPU tensors: the plain stage
    assert h.shape == (t, 4 * c) and h.dtype == x.dtype
    assert torch.equal(h, tff.geglu_in_plain(x, w_in, b_in))
    got = tff.geglu_out(h, w_out, b_out)
    assert torch.equal(got, tff.geglu_ff_plain(x, w_in, b_in, w_out, b_out))
    assert torch.equal(got, _geglu_one_expression(x, w_in, b_in, w_out, b_out))
    jargs = [jnp.asarray(a, getattr(jnp, dtype)) for a in params]
    _check(got, jff.geglu_ff(*jargs, interpret=True), dtype)
    resid = torch.from_numpy(np.random.default_rng(t).normal(size=(t, c)).astype(np.float32))
    resid = resid.to(x.dtype)
    assert torch.equal(tff.geglu_out_plain(h, w_out, b_out, resid),
                       geglu_residual(x, resid, w_in, b_in, w_out, b_out))


@pytest.mark.parametrize("fn,c,inner,msg", [
    ("geglu_ff", 320, 1280, "unsupported device"),
    ("geglu_ff", 96, 384, "unsupported width"),
    ("geglu_ff", 64, 192, "unsupported width"),  # inner not a multiple of 128
    ("geglu_in", 64, 192, "unsupported width"),
    ("geglu_out", 96, 384, "unsupported width"),
    ("geglu_out", 320, 1280, "unsupported device"),
])
def test_geglu_wrappers_refuse_what_the_kernels_do_not_take(fn, c, inner, msg):
    """Off the CPU the wrappers launch the kernels or raise: shapes the
    kernels do not tile (C % 64, I % 128 for geglu_in) and devices that are
    neither the CPU nor a CUDA card are refused before any launch."""
    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")
    w_in, b_in, w_out, b_out = meta(2 * inner, c), meta(2 * inner), meta(c, inner), meta(c)
    args = {"geglu_ff": (meta(8, c), w_in, b_in, w_out, b_out),
            "geglu_in": (meta(8, c), w_in, b_in),
            "geglu_out": (meta(8, inner), w_out, b_out)}[fn]
    with pytest.raises(ValueError, match=msg):
        getattr(tff, fn)(*args)


# --- GroupNorm + pre-bias + SiLU (row 9) -------------------------------------

def _gn_inputs(n, l, c, seed):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(n, l, c)) * 2 + 0.5).astype(np.float32),
            (rng.uniform(size=(c,)) + 0.5).astype(np.float32),
            (rng.normal(size=(c,)) * 0.1).astype(np.float32),
            rng.normal(size=(n, c)).astype(np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_group_norm_plain_matches_pallas_and_reference(dtype, act, with_bias):
    x, gamma, beta, bias = _gn_inputs(3, 40, 64, seed=int(with_bias))
    if not with_bias:
        bias = np.zeros_like(bias)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jb = jnp.asarray(x, jdt), jnp.asarray(bias, jdt)
    kw = dict(groups=8, eps=1e-5, act=act)
    got = tgn.group_norm_act(torch.from_numpy(x).to(tdt), torch.from_numpy(gamma),
                             torch.from_numpy(beta), bias=torch.from_numpy(bias).to(tdt),
                             **kw)
    _check(got, jgn._gn_pallas(jx, gamma, beta, jb, **kw), dtype)
    _check(got, jgn._gn_reference(jx, gamma, beta, jb, **kw), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_group_norm_matches_flax_over_video_axes(dtype):
    """TransformerTemporal's norm: statistics over (F, H, W) jointly of a
    (B, F, H, W, C) tensor, eps 1e-6, as flax.linen.GroupNorm computes it."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 4, 5, 6, 32)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    gn = nn.GroupNorm(num_groups=8, epsilon=1e-6, dtype=jdt)
    params = {"params": {"scale": np.linspace(0.5, 1.5, 32, dtype=np.float32),
                         "bias": np.linspace(-0.1, 0.1, 32, dtype=np.float32)}}
    want = gn.apply(params, jnp.asarray(x, jdt))
    got = tgn.group_norm_act(torch.from_numpy(x).to(tdt),
                             torch.from_numpy(params["params"]["scale"]),
                             torch.from_numpy(params["params"]["bias"]),
                             groups=8, eps=1e-6)
    _check(got, want, dtype)


def test_group_norm_vs_reference_resnet_fallback():
    """The port sends every GroupNorm through its fused kernel; on every
    backend but the TPU the reference's ResnetBlock2D instead adds the time
    embedding in bf16, runs flax GroupNorm to bf16, then SiLU in bf16
    (layers.py _gn_silu). Those three extra bf16 roundings (the first of an
    input up to ~4x the output's scale) move the result by about two bf16
    ulps at its largest values (measured 2^-4 at max|y| = 4.8); the bound is
    4 * 2^-8 * max|y|."""
    x, gamma, beta, bias = _gn_inputs(4, 64, 64, seed=9)
    jx, jb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(bias, jnp.bfloat16)
    h = (jx.reshape(4, 8, 8, 64) + jb[:, None, None, :])
    gn = nn.GroupNorm(num_groups=8, epsilon=1e-5, dtype=jnp.bfloat16)
    want = nn.silu(gn.apply({"params": {"scale": gamma, "bias": beta}}, h))
    got = tgn.group_norm_act(torch.from_numpy(x).to(torch.bfloat16).reshape(4, 8, 8, 64),
                             torch.from_numpy(gamma), torch.from_numpy(beta),
                             groups=8, eps=1e-5, act="silu",
                             bias=torch.from_numpy(bias).to(torch.bfloat16))
    err = np.abs(_f32(got) - _f32(want)).max()
    print(f"parity: max_abs_err {err:.3g}, max_abs_ref {np.abs(_f32(want)).max():.3g}")
    assert err <= 4 * 2 ** -8 * np.abs(_f32(want)).max(), err
