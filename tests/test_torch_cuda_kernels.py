"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every case is marked ``cuda`` and skips where there is no CUDA card.

This file imports no JAX (the card's machine has none); run it there with
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q``. The
plain versions themselves are held to the JAX package by the CPU tests
(``tests/test_torch_attention_kernels.py``, ``test_torch_ff_gn_kernels.py``).

Tolerance: both sides round to bf16 at the same points but sum in other
orders, and the flash kernel rounds unnormalised probabilities where the
plain version rounds normalised ones; 4 bf16 ulps of the output's scale
(4 * 2^-8 * max|plain|).
"""

import numpy as np
import pytest
import torch

from dvdx_tpu_torch.ops import groupnorm as tgn
from dvdx_tpu_torch.ops.kernels import flash_attention as tflash
from dvdx_tpu_torch.ops.kernels import geglu_ff as tff
from dvdx_tpu_torch.ops.kernels import spatial_tail as ttail
from dvdx_tpu_torch.ops.kernels import temporal_attention as ttemp
from dvdx_tpu_torch.ops.kernels import temporal_block as tblock

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(shape, seed, device, scale=1.0, shift=0.0):
    x = np.random.default_rng(seed).normal(size=shape) * scale + shift
    return torch.from_numpy(x.astype(np.float32)).to(device)


def _check(got, want):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    assert err <= 4 * 2 ** -8 * want.abs().max().item(), err


@pytest.mark.parametrize("b,s,h,d", [(2, 600, 5, 64), (1, 77, 2, 40), (1, 130, 3, 128)])
def test_flash_kernel_matches_plain(cuda, b, s, h, d):
    q, k, v = (_randn((b, s, h, d), i, cuda).bfloat16() for i in range(3))
    before = tflash.LAUNCHES
    got = tflash.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tflash.LAUNCHES == before + 1
    _check(got, tflash.flash_attention_plain(q, k, v))


@pytest.mark.parametrize("layout", ["frame_major", "position_major"])
@pytest.mark.parametrize("f,n,heads,d", [(16, 45, 5, 64), (16, 100, 8, 40), (24, 7, 2, 128)])
def test_temporal_kernel_matches_plain(cuda, layout, f, n, heads, d):
    shape = (2, f, n, heads * d) if layout == "frame_major" else (2, n, f, heads * d)
    q, k, v = (_randn(shape, i, cuda).bfloat16() for i in range(3))
    before = ttemp.LAUNCHES
    if layout == "frame_major":
        got = ttemp.temporal_attention(q, k, v, heads=heads)
        want = ttemp.temporal_attention_plain(q, k, v, heads=heads)
    else:
        got = ttemp.temporal_attention_posmajor(q, k, v, heads=heads)
        want = ttemp.temporal_attention_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            heads=heads).transpose(1, 2)
    torch.cuda.synchronize()
    assert ttemp.LAUNCHES == before + 1
    _check(got, want)


@pytest.mark.parametrize("t,c", [(300, 320), (100, 640), (77, 1280)])
def test_geglu_kernel_matches_plain(cuda, t, c):
    inner = 4 * c
    args = [_randn((t, c), 0, cuda), _randn((2 * inner, c), 1, cuda, c ** -0.5),
            _randn((2 * inner,), 2, cuda, 0.1), _randn((c, inner), 3, cuda, inner ** -0.5),
            _randn((c,), 4, cuda, 0.1)]
    args = [a.bfloat16() for a in args]
    before = tff.LAUNCHES
    got = tff.geglu_ff(*args)
    torch.cuda.synchronize()
    assert tff.LAUNCHES == before + 1
    _check(got, tff.geglu_ff_plain(*args))


@pytest.mark.parametrize("n,l,c,act,with_bias", [
    (32, 2880, 320, "silu", True), (2, 46080, 320, "none", False),
    (4, 45, 2560, "silu", False), (1, 70, 512, "silu", False),
    (1, 184320, 128, "silu", False)])
def test_group_norm_kernel_matches_plain(cuda, n, l, c, act, with_bias):
    x = _randn((n, l, c), 0, cuda, 2.0, 0.5).bfloat16()
    gamma = _randn((c,), 1, cuda, 0.2, 1.0)
    beta = _randn((c,), 2, cuda, 0.1)
    bias = _randn((n, c), 3, cuda).bfloat16() if with_bias else None
    kw = dict(groups=32, eps=1e-5, act=act, bias=bias)
    before = tgn.LAUNCHES
    got = tgn.group_norm_act(x, gamma, beta, **kw)
    torch.cuda.synchronize()
    assert tgn.LAUNCHES == before + 1
    _check(got, tgn.group_norm_act_plain(x, gamma, beta, **kw))


def _params(keys, shapes, seed, device):
    """bf16 parameters: weights N(0, 1/fan_in), biases N(0, 0.1^2), LayerNorm
    scales 1 + N(0, 0.1^2), LayerNorm biases N(0, 0.1^2)."""
    out = {}
    for i, key in enumerate(keys):
        shape = shapes[key]
        if len(shape) == 2:
            t = _randn(shape, seed + i, device, shape[1] ** -0.5)
        elif key.endswith("_s"):
            t = _randn(shape, seed + i, device, 0.1, 1.0)
        else:
            t = _randn(shape, seed + i, device, 0.1)
        out[key] = t.bfloat16()
    return out


@pytest.mark.parametrize("b,sq,sk,heads,d", [(2, 600, 600, 2, 64), (2, 300, 77, 3, 40)])
def test_flash_mh_kernel_matches_plain(cuda, b, sq, sk, heads, d):
    """Head strips of 128 lanes, zero pad lanes in; the pad lanes out are
    exactly zero."""
    def strips(s, seed):
        x = _randn((b, s, heads, 128), seed, cuda)
        x[..., d:] = 0
        return x.reshape(b, s, heads * 128).bfloat16()
    q, k, v = strips(sq, 0), strips(sk, 1), strips(sk, 2)
    before = tflash.MH_LAUNCHES
    got = tflash.flash_attention_mh(q, k, v, heads=heads, head_dim=d)
    torch.cuda.synchronize()
    assert tflash.MH_LAUNCHES == before + 1
    assert got.view(b, sq, heads, 128)[..., d:].abs().max().item() == 0.0
    _check(got, tflash.flash_attention_mh_plain(q, k, v, heads=heads, head_dim=d))


@pytest.mark.parametrize("n,s,c,heads,t", [(2, 300, 320, 5, 77), (1, 100, 640, 10, 77),
                                           (2, 70, 64, 1, 16)])
def test_spatial_tail_kernel_matches_plain(cuda, n, s, c, heads, t):
    shapes = {"o1_w": (c, c), "o1_b": (c,), "ln2_s": (c,), "ln2_b": (c,),
              "q2_w": (c, c), "o2_w": (c, c), "o2_b": (c,), "ln3_s": (c,),
              "ln3_b": (c,), "ffi_w": (8 * c, c), "ffi_b": (8 * c,),
              "ffo_w": (c, 4 * c), "ffo_b": (c,)}
    params = _params(ttail.KEYS, shapes, 10, cuda)
    x = _randn((n, s, c), 0, cuda).bfloat16()
    o1 = _randn((n, s, c), 1, cuda).bfloat16()
    ctx_k = _randn((n, t, c), 2, cuda).bfloat16()
    ctx_v = _randn((n, t, c), 3, cuda).bfloat16()
    before = ttail.LAUNCHES
    got = ttail.fused_spatial_tail(x, o1, ctx_k, ctx_v, params, heads=heads)
    torch.cuda.synchronize()
    assert ttail.LAUNCHES == before + 1
    _check(got, ttail.fused_spatial_tail_plain(x, o1, ctx_k, ctx_v, params, heads=heads))


@pytest.mark.parametrize("b,f,n,c,heads", [(2, 16, 100, 320, 5), (1, 16, 77, 320, 8),
                                           (1, 4, 70, 64, 8), (1, 24, 10, 64, 1)])
def test_temporal_block_kernel_matches_plain(cuda, b, f, n, c, heads):
    shapes = {k: (c, c) for k in ("q1", "k1", "v1", "o1_w", "q2", "k2", "v2", "o2_w")}
    shapes.update({k: (c,) for k in tblock.KEYS if k[:2] in ("ln", "o1", "o2")
                   and not k.endswith("_w")})
    shapes.update({"ffi_w": (8 * c, c), "ffi_b": (8 * c,), "ffo_w": (c, 4 * c),
                   "ffo_b": (c,)})
    params = _params(tblock.KEYS, shapes, 20, cuda)
    x = _randn((b, f, n, c), 0, cuda).bfloat16()
    before = tblock.LAUNCHES
    got = tblock.fused_temporal_block(x, params, heads=heads)
    torch.cuda.synchronize()
    assert tblock.LAUNCHES == before + 1
    _check(got, tblock.fused_temporal_block_plain(x, params, heads=heads))
