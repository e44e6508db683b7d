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
from dvdx_tpu_torch.ops.kernels import attention_f32 as tatt32
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


# S = 2880 (level 0) and 777 leave ragged query and key tiles; D = 40 and 128
# take the one-box and two-box paths with zero-filled pad lanes
@pytest.mark.parametrize("b,s,h,d", [(2, 600, 5, 64), (1, 77, 2, 40), (1, 130, 3, 128),
                                     (1, 2880, 2, 64), (2, 777, 3, 40), (1, 777, 2, 128),
                                     (1, 2880, 1, 128)])
def test_flash_kernel_matches_plain(cuda, b, s, h, d):
    q, k, v = (_randn((b, s, h, d), i, cuda).bfloat16() for i in range(3))
    before = tflash.LAUNCHES
    got = tflash.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tflash.LAUNCHES == before + 1
    _check(got, tflash.flash_attention_plain(q, k, v))


# then every frame count the redesigned kernel plans for (one to eight
# 16-frame query tiles, 8 down to 1 positions a tile) at the one-box and
# two-box head widths, N = 45 leaving a ragged last tile
@pytest.mark.parametrize("layout", ["frame_major", "position_major"])
@pytest.mark.parametrize("f,n,heads,d", [(16, 45, 5, 64), (16, 100, 8, 40), (24, 7, 2, 128)]
                         + [(f, 45, 3, d) for f in (16, 24, 40, 64, 128) for d in (40, 64, 128)])
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


def _geglu_args(t, c, device):
    inner = 4 * c
    args = [_randn((t, c), 0, device), _randn((2 * inner, c), 1, device, c ** -0.5),
            _randn((2 * inner,), 2, device, 0.1), _randn((c, inner), 3, device, inner ** -0.5),
            _randn((c,), 4, device, 0.1)]
    return [a.bfloat16() for a in args]


# T = 77, 300, 5761: one partial 128-row tile, a ragged last tile, many
# tiles; C = 320 takes 160-column output tiles, 640 and 1280 128-column ones
@pytest.mark.parametrize("c", [320, 640, 1280])
@pytest.mark.parametrize("t", [77, 300, 5761])
def test_geglu_kernel_matches_plain(cuda, t, c):
    args = _geglu_args(t, c, cuda)
    before = tff.LAUNCHES
    got = tff.geglu_ff(*args)
    torch.cuda.synchronize()
    assert tff.LAUNCHES == before + 1
    _check(got, tff.geglu_ff_plain(*args))


@pytest.mark.parametrize("t,c", [(300, 320), (77, 1280)])
def test_geglu_stage_kernels_match_plain(cuda, t, c):
    """geglu_in and geglu_out on their own, the latter with and without the
    residual epilogue the fused kernels use."""
    x, w_in, b_in, w_out, b_out = _geglu_args(t, c, cuda)
    h = tff.geglu_in(x, w_in, b_in)
    torch.cuda.synchronize()
    _check(h, tff.geglu_in_plain(x, w_in, b_in))
    resid = _randn((t, c), 5, cuda).bfloat16()
    for r in (None, resid):
        _check(tff.geglu_out(h, w_out, b_out, r), tff.geglu_out_plain(h, w_out, b_out, r))


def test_redesigned_kernels_repeat_bitwise(cuda):
    """Flash attention (both head-dim paths, ragged tiles, the mh entry point
    with its own key length) and the GEGLU pair give the same bits on the
    same inputs: the tile shapes depend on the shapes alone, and nothing sums
    across blocks."""
    runs = []
    for d in (64, 128):
        q, k, v = (_randn((2, 777, 3, d), i, cuda).bfloat16() for i in range(3))
        runs.append(lambda q=q, k=k, v=v: tflash.flash_attention(q, k, v))
    strips = [_randn((2, s, 2 * 128), i, cuda).bfloat16() for i, s in enumerate((300, 77, 77))]
    runs.append(lambda: tflash.flash_attention_mh(*strips, heads=2, head_dim=128))
    args = _geglu_args(5761, 320, cuda)
    runs.append(lambda: tff.geglu_ff(*args))
    for run in runs:
        first = run()
        second = run()
        torch.cuda.synchronize()
        assert torch.equal(first.view(torch.int16), second.view(torch.int16))


def _group_norm_args(n, l, c, with_bias, device):
    x = _randn((n, l, c), 0, device, 2.0, 0.5).bfloat16()
    gamma = _randn((c,), 1, device, 0.2, 1.0)
    beta = _randn((c,), 2, device, 0.1)
    bias = _randn((n, c), 3, device).bfloat16() if with_bias else None
    return x, gamma, beta, bias


# the UNet's widest row (32, 45, 2560), its largest sample (2, 46080, 320),
# with and without the pre-bias, L not a multiple of the planned chunk
# (1000 rows in chunks of 51), one sample, and the VAE's largest rows
@pytest.mark.parametrize("n,l,c,act,with_bias", [
    (32, 2880, 320, "silu", True), (2, 46080, 320, "none", False),
    (2, 46080, 320, "none", True), (4, 45, 2560, "silu", False),
    (32, 45, 2560, "silu", False), (3, 1000, 320, "silu", True),
    (1, 70, 512, "silu", False), (1, 184320, 128, "silu", False),
    (1, 184320, 256, "silu", False)])
def test_group_norm_kernel_matches_plain(cuda, n, l, c, act, with_bias):
    x, gamma, beta, bias = _group_norm_args(n, l, c, with_bias, cuda)
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


@pytest.mark.parametrize("b,sq,sk,heads,d", [(2, 600, 600, 2, 64), (2, 300, 77, 3, 40),
                                             (1, 777, 2880, 2, 64), (1, 2880, 777, 2, 128)])
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
    if d < 128:
        assert got.view(b, sq, heads, 128)[..., d:].abs().max().item() == 0.0
    _check(got, tflash.flash_attention_mh_plain(q, k, v, heads=heads, head_dim=d))


def _spatial_tail_args(n, s, c, t, device):
    shapes = {"o1_w": (c, c), "o1_b": (c,), "ln2_s": (c,), "ln2_b": (c,),
              "q2_w": (c, c), "o2_w": (c, c), "o2_b": (c,), "ln3_s": (c,),
              "ln3_b": (c,), "ffi_w": (8 * c, c), "ffi_b": (8 * c,),
              "ffo_w": (c, 4 * c), "ffo_b": (c,)}
    params = _params(ttail.KEYS, shapes, 10, device)
    return ([_randn(shape, i, device).bfloat16()
             for i, shape in enumerate(((n, s, c), (n, s, c), (n, t, c), (n, t, c)))], params)


# then the 64-row chain at the UNet's level 0 (45 tiles an image), C = 384
# (two ring stages of 24 KB), S = 721 (tiles spanning two images), T = 300
# (two sweeps over 128-token fills), C = 64 with T = 16 and S = 20 (three
# images in one tile), head width 40 (the mma.sync path, zero-filled
# lanes), and the wide chain at C = 640
@pytest.mark.parametrize("n,s,c,heads,t", [
    (2, 300, 320, 5, 77), (1, 100, 640, 10, 77), (2, 70, 64, 1, 16),
    (32, 2880, 320, 5, 77), (2, 600, 384, 6, 77), (3, 721, 320, 5, 77), (2, 300, 320, 5, 300),
    (3, 20, 64, 1, 16), (2, 130, 320, 8, 77), (2, 720, 640, 10, 77)])
def test_spatial_tail_kernel_matches_plain(cuda, n, s, c, heads, t):
    (x, o1, ctx_k, ctx_v), params = _spatial_tail_args(n, s, c, t, cuda)
    before = ttail.LAUNCHES
    got = ttail.fused_spatial_tail(x, o1, ctx_k, ctx_v, params, heads=heads)
    torch.cuda.synchronize()
    assert ttail.LAUNCHES == before + 1
    _check(got, ttail.fused_spatial_tail_plain(x, o1, ctx_k, ctx_v, params, heads=heads))


def test_spatial_chain_and_frame_attention_repeat_bitwise(cuda):
    """The redesigned chain (one pass, two sweeps, spanning tiles) and
    frame-axis attention (both layouts, 16 and 128 frames) give the same
    bits on the same inputs: persistent CTAs take tiles in any order, but
    each tile's sums have one order."""
    runs = []
    for n, s, c, heads, t in ((3, 721, 320, 5, 77), (2, 300, 320, 5, 300)):
        (x, o1, ck, cv), params = _spatial_tail_args(n, s, c, t, cuda)
        runs.append(lambda a=(x, o1, ck, cv), p=params, h=heads:
                    ttail.fused_spatial_tail(*a, p, heads=h))
    for f, layout in ((16, "fm"), (128, "fm"), (16, "pm"), (40, "pm")):
        shape = (2, f, 180, 320) if layout == "fm" else (2, 180, f, 320)
        q, k, v = (_randn(shape, i, cuda).bfloat16() for i in range(3))
        fn = ttemp.temporal_attention if layout == "fm" else ttemp.temporal_attention_posmajor
        runs.append(lambda q=q, k=k, v=v, fn=fn: fn(q, k, v, heads=5))
    for run in runs:
        first = run()
        second = run()
        torch.cuda.synchronize()
        assert torch.equal(first.view(torch.int16), second.view(torch.int16))


def test_unfused_temporal_block_at_40_frames_matches_cpu(cuda):
    """A _TemporalBlock at C = 640 (past the fused block's widths) over 40
    frames -- which raised on the card before frame-axis attention took
    F > 32 -- runs its frame-axis attention kernel and GEGLU on the card and
    agrees with its CPU run (the plain versions) within the kernels'
    tolerance."""
    from dvdx_tpu_torch.models import layers

    torch.manual_seed(0)
    block = layers._TemporalBlock(640, 10, 64)
    with torch.no_grad():
        for prm in block.parameters():
            prm.add_(0.05 * torch.randn_like(prm))
    block = block.bfloat16()
    x = _randn((1, 40, 45, 640), 7, "cpu").bfloat16()
    assert not block.fused(x) and layers.temporal_attention_wants(40, 64)
    with torch.no_grad():
        want = block(x)
        before = ttemp.LAUNCHES
        got = block.to(cuda)(x.to(cuda))
        torch.cuda.synchronize()
    assert ttemp.LAUNCHES == before + 2
    _check(got.cpu(), want)


def _temporal_block_args(b, f, n, c, device):
    shapes = {k: (c, c) for k in ("q1", "k1", "v1", "o1_w", "q2", "k2", "v2", "o2_w")}
    shapes.update({k: (c,) for k in tblock.KEYS if k[:2] in ("ln", "o1", "o2")
                   and not k.endswith("_w")})
    shapes.update({"ffi_w": (8 * c, c), "ffi_b": (8 * c,), "ffo_w": (c, 4 * c),
                   "ffo_b": (c,)})
    return _randn((b, f, n, c), 0, device).bfloat16(), _params(tblock.KEYS, shapes, 20, device)


# F = 16 (4 positions a tile) with N = 101 and 77 not multiples of it, F =
# 24 (the XL geometry: 2 positions, keys padded to 32) with heads 5 x 64 and
# 8 x 40, F = 40 and 64 (one position, 3 and 4 query tiles), C = 64 / 128 /
# 384 (other wgmma widths and ring depths), an odd tile count
@pytest.mark.parametrize("b,f,n,c,heads", [
    (2, 16, 100, 320, 5), (1, 16, 77, 320, 8), (2, 16, 101, 320, 5), (1, 24, 45, 320, 5),
    (1, 24, 45, 320, 8), (1, 4, 70, 64, 8), (1, 24, 10, 64, 1), (1, 40, 5, 128, 2),
    (1, 64, 3, 384, 6)])
def test_temporal_block_kernel_matches_plain(cuda, b, f, n, c, heads):
    x, params = _temporal_block_args(b, f, n, c, cuda)
    before = tblock.LAUNCHES
    got = tblock.fused_temporal_block(x, params, heads=heads)
    torch.cuda.synchronize()
    assert tblock.LAUNCHES == before + 1
    _check(got, tblock.fused_temporal_block_plain(x, params, heads=heads))


def test_chain_and_group_norm_repeat_bitwise(cuda):
    """The temporal block (its chain and FF launches) and GroupNorm (the
    grid-wide reduction) give the same bits on the same inputs: the tiling
    and the chunking depend on the shapes alone, and no sum goes through an
    atomic."""
    runs = []
    for b, f, n, c, heads in ((2, 16, 101, 320, 5), (1, 24, 45, 320, 8)):
        x, params = _temporal_block_args(b, f, n, c, cuda)
        runs.append(lambda x=x, p=params, h=heads: tblock.fused_temporal_block(x, p, heads=h))
    for n, l, c, with_bias in ((2, 46080, 320, True), (32, 45, 2560, False),
                               (1, 184320, 256, False)):
        x, gamma, beta, bias = _group_norm_args(n, l, c, with_bias, cuda)
        runs.append(lambda x=x, g=gamma, be=beta, bi=bias: tgn.group_norm_act(
            x, g, be, groups=32, eps=1e-6, act="silu", bias=bi))
    for run in runs:
        first = run()
        second = run()
        torch.cuda.synchronize()
        assert torch.equal(first.view(torch.int16), second.view(torch.int16))


# --- float32 and any width: what the float32 test models hand the kernels ---
# Tolerance: both sides compute in f32 and sum in other orders; 1e-5 of the
# output's scale, 1e-4 for GroupNorm, whose one-pass variance over up to 1e5
# elements a group cancels most of its sums.

def _check_f32(got, want, rel=1e-5):
    assert got.dtype == torch.float32
    err = (got - want).abs().max().item()
    assert err <= rel * want.abs().max().item(), err


# zeroscope-tiny's UNet (levels 0-1 at 32x32, 4 frames) and its VAE, and a
# wide row with a ragged chunk
@pytest.mark.parametrize("n,l,c,act,with_bias", [
    (8, 16, 32, "silu", True), (2, 64, 32, "none", False), (8, 4, 64, "silu", False),
    (4, 1024, 64, "silu", False), (3, 1000, 320, "silu", True)])
def test_group_norm_float32_kernel_matches_plain(cuda, n, l, c, act, with_bias):
    x, gamma, beta, bias = _group_norm_args(n, l, c, with_bias, cuda)
    x, bias = x.float(), None if bias is None else bias.float()
    kw = dict(groups=8 if c < 320 else 32, eps=1e-5, act=act, bias=bias)
    before = tgn.F32_LAUNCHES
    got = tgn.group_norm_act(x, gamma, beta, **kw)
    torch.cuda.synchronize()
    assert tgn.F32_LAUNCHES == before + 1
    _check_f32(got, tgn.group_norm_act_plain(x, gamma, beta, **kw), 1e-4)
    assert torch.equal(got, tgn.group_norm_act(x, gamma, beta, **kw))


# zeroscope-tiny's FF (C = 32 and 64), ragged tiles, a width that is no
# multiple of 4, and bf16 at widths the wgmma pair does not take
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,c", [(64, 32), (128, 64), (77, 40), (300, 320), (33, 30)])
def test_geglu_cuda_core_kernels_match_plain(cuda, dtype, t, c):
    args = [a.to(dtype) for a in _geglu_args(t, c, cuda)]
    wgmma = tff.wgmma_takes(dtype, c, 4 * c)
    before = tff.LAUNCHES, tff.SIMT_LAUNCHES
    got = tff.geglu_ff(*args)
    torch.cuda.synchronize()
    assert (tff.LAUNCHES, tff.SIMT_LAUNCHES) == (before[0] + wgmma, before[1] + (not wgmma))
    want = tff.geglu_ff_plain(*args)
    if dtype == torch.float32:
        _check_f32(got, want)
    else:
        _check(got, want)
    assert torch.equal(got, tff.geglu_ff(*args))


@pytest.mark.parametrize("b,s,h,d", [(2, 16, 2, 16), (1, 600, 2, 64), (1, 130, 3, 128),
                                     (2, 77, 1, 40)])
def test_flash_float32_kernel_matches_plain(cuda, b, s, h, d):
    q, k, v = (_randn((b, s, h, d), i, cuda) for i in range(3))
    before = tflash.F32_LAUNCHES
    got = tflash.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tflash.F32_LAUNCHES == before + 1
    _check_f32(got, tflash.flash_attention_plain(q, k, v))
    assert torch.equal(got, tflash.flash_attention(q, k, v))


# the tensor-core body at the float32 UNet's flash shapes (levels 0 and 1 at
# batch 2), a ragged S at D = 40, and 66-float rows, which its 16-byte copies
# cannot take (the shape gate sends them to the CUDA-core rows); the same
# bits again
@pytest.mark.parametrize("b,s,h,d,pad", [(2, 2880, 5, 64, 0), (2, 720, 10, 64, 0),
                                         (2, 777, 3, 40, 0), (1, 600, 2, 64, 2)])
def test_flash_float32_tensor_core_body_matches_plain(cuda, b, s, h, d, pad):
    q, k, v = (_randn((b, s, h, d + pad), 10 + i, cuda)[..., :d] for i in range(3))
    before = tflash.F32_LAUNCHES, tatt32.TENSOR_CORE_LAUNCHES
    got = tflash.flash_attention(q, k, v)
    again = tflash.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tflash.F32_LAUNCHES == before[0] + 2
    assert tatt32.TENSOR_CORE_LAUNCHES == before[1] + 2 * (pad == 0)
    _check_f32(got, tflash.flash_attention_plain(q, k, v))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


# float32 GEGLU at level 1's and level 2's widths with ragged row tiles
@pytest.mark.parametrize("t,c", [(1001, 640), (333, 1280)])
def test_geglu_float32_wide_kernel_matches_plain(cuda, t, c):
    args = [a.float() for a in _geglu_args(t, c, cuda)]
    before = tff.SIMT_LAUNCHES
    got = tff.geglu_ff(*args)
    again = tff.geglu_ff(*args)
    torch.cuda.synchronize()
    assert tff.SIMT_LAUNCHES == before + 2
    _check_f32(got, tff.geglu_ff_plain(*args))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("layout", ["frame_major", "position_major"])
# the last: B * N = 80,000 positions, past one grid axis's 65,535
@pytest.mark.parametrize("f,n,heads,d", [(4, 16, 2, 16), (16, 45, 5, 64), (128, 7, 1, 128),
                                         (4, 40000, 1, 16)])
def test_temporal_float32_kernel_matches_plain(cuda, layout, f, n, heads, d):
    shape = (2, f, n, heads * d) if layout == "frame_major" else (2, n, f, heads * d)
    q, k, v = (_randn(shape, i, cuda) for i in range(3))
    before = ttemp.F32_LAUNCHES
    if layout == "frame_major":
        got = ttemp.temporal_attention(q, k, v, heads=heads)
        want = ttemp.temporal_attention_plain(q, k, v, heads=heads)
    else:
        got = ttemp.temporal_attention_posmajor(q, k, v, heads=heads)
        want = ttemp.temporal_attention_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            heads=heads).transpose(1, 2)
    torch.cuda.synchronize()
    assert ttemp.F32_LAUNCHES == before + 1
    _check_f32(got, want)


# the short-sequence body of the float32 attention: 1 to 63 frames (the
# UNet's 16, XL's 24, one m16 tile ragged and four), head widths 16 to 128
# (40: lanes past D zero), N = 37 positions leaving a ragged last run, in
# both layouts; within 1e-5, the same bits again
@pytest.mark.parametrize("layout", ["frame_major", "position_major"])
@pytest.mark.parametrize("d", [16, 40, 64, 128])
@pytest.mark.parametrize("f", [1, 4, 16, 24, 63])
def test_temporal_float32_frames_body_matches_plain(cuda, layout, f, d):
    _frames_case(cuda, layout, 2, f, 37, 3, d)


# B * N = 80,000 positions: the persistent grid walks them, no grid axis
# holds them
@pytest.mark.parametrize("layout", ["frame_major", "position_major"])
def test_temporal_float32_frames_body_past_65535_positions(cuda, layout):
    _frames_case(cuda, layout, 2, 16, 40000, 1, 16)


def _frames_case(cuda, layout, b, f, n, heads, d):
    shape = (b, f, n, heads * d) if layout == "frame_major" else (b, n, f, heads * d)
    q, k, v = (_randn(shape, 20 + i, cuda) for i in range(3))
    if layout == "frame_major":
        run = lambda: ttemp.temporal_attention(q, k, v, heads=heads)  # noqa: E731
        want = ttemp.temporal_attention_plain(q, k, v, heads=heads)
    else:
        run = lambda: ttemp.temporal_attention_posmajor(q, k, v, heads=heads)  # noqa: E731
        want = ttemp.temporal_attention_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            heads=heads).transpose(1, 2)
    before = ttemp.F32_LAUNCHES, tatt32.FRAMES_LAUNCHES
    got, again = run(), run()
    torch.cuda.synchronize()
    assert (ttemp.F32_LAUNCHES, tatt32.FRAMES_LAUNCHES) == (before[0] + 2, before[1] + 2)
    _check_f32(got, want)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def _float32(args):
    """bf16 test arguments (tensors, and dicts of them) as float32."""
    tensors, params = args
    return [t.float() for t in tensors], {k: v.float() for k, v in params.items()}


# the fused kernels' float32 forms: the UNet's level 0 at a smaller batch, S
# = 721 (a ragged last row tile), T = 300, C = 64 with T = 16, head width 40
# and C = 640 (the shapes the bf16 wide chain takes)
@pytest.mark.parametrize("n,s,c,heads,t", [
    (4, 2880, 320, 5, 77), (3, 721, 320, 5, 77), (2, 300, 320, 5, 300), (3, 20, 64, 1, 16),
    (2, 130, 320, 8, 77), (2, 720, 640, 10, 77)])
def test_spatial_tail_float32_kernel_matches_plain(cuda, n, s, c, heads, t):
    (x, o1, ctx_k, ctx_v), params = _float32(_spatial_tail_args(n, s, c, t, cuda))
    before = ttail.F32_LAUNCHES, ttail.LAUNCHES
    got = ttail.fused_spatial_tail(x, o1, ctx_k, ctx_v, params, heads=heads)
    again = ttail.fused_spatial_tail(x, o1, ctx_k, ctx_v, params, heads=heads)
    torch.cuda.synchronize()
    assert (ttail.F32_LAUNCHES, ttail.LAUNCHES) == (before[0] + 2, before[1])
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    _check_f32(got, ttail.fused_spatial_tail_plain(x, o1, ctx_k, ctx_v, params, heads=heads))


# the fused kernels' float32 forms at the float32 UNet's level-0 widths (C
# = 320, 5 heads of 64, 77 context tokens, 16 frames), both at batch 2 as
# the CFG pair runs them: the products and the tail's cross-attention on
# the tensor cores, the same bits again
def test_fused_float32_kernels_at_level0_widths_repeat_bitwise(cuda):
    (x, o1, ctx_k, ctx_v), params = _float32(_spatial_tail_args(2, 2880, 320, 77, cuda))
    before = tatt32.TENSOR_CORE_LAUNCHES
    got = ttail.fused_spatial_tail(x, o1, ctx_k, ctx_v, params, heads=5)
    again = ttail.fused_spatial_tail(x, o1, ctx_k, ctx_v, params, heads=5)
    torch.cuda.synchronize()
    assert tatt32.TENSOR_CORE_LAUNCHES == before + 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    _check_f32(got, ttail.fused_spatial_tail_plain(x, o1, ctx_k, ctx_v, params, heads=5))
    xb, pb = _temporal_block_args(2, 16, 2880, 320, cuda)
    xb, pb = xb.float(), {k: v.float() for k, v in pb.items()}
    got = tblock.fused_temporal_block(xb, pb, heads=5)
    again = tblock.fused_temporal_block(xb, pb, heads=5)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    _check_f32(got, tblock.fused_temporal_block_plain(xb, pb, heads=5))


# the UNet's level 0 at one sample and at the CFG batch's two, and
# transformer_in's 8 x 40 heads, a ragged N, F = 24, F = 64 at C = 384, and
# one 384-wide head
@pytest.mark.parametrize("b,f,n,c,heads", [
    (1, 16, 2880, 320, 5), (2, 16, 2880, 320, 5), (1, 16, 2880, 320, 8), (2, 16, 101, 320, 5),
    (1, 24, 45, 320, 8), (1, 64, 3, 384, 6), (1, 4, 70, 384, 1)])
def test_temporal_block_float32_kernel_matches_plain(cuda, b, f, n, c, heads):
    x, params = _temporal_block_args(b, f, n, c, cuda)
    x, params = x.float(), {k: v.float() for k, v in params.items()}
    before = tblock.F32_LAUNCHES, tblock.LAUNCHES, tatt32.FRAMES_LAUNCHES
    got = tblock.fused_temporal_block(x, params, heads=heads)
    again = tblock.fused_temporal_block(x, params, heads=heads)
    torch.cuda.synchronize()
    assert (tblock.F32_LAUNCHES, tblock.LAUNCHES) == (before[0] + 2, before[1])
    # two attentions a launch on the short-sequence body below 64 frames
    frames = tblock.f32_attention_body(f, n, c, heads) == "frames"
    assert tatt32.FRAMES_LAUNCHES == before[2] + 4 * frames
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    _check_f32(got, tblock.fused_temporal_block_plain(x, params, heads=heads))


def test_fused_kernels_take_float32_and_refuse_float16(cuda):
    """float32 launches the float32 kernels (no error); float16, which no
    kernel takes, still raises."""
    (x, o1, ck, cv), tail_params = _spatial_tail_args(2, 70, 64, 16, cuda)
    xb, block_params = _temporal_block_args(1, 4, 70, 64, cuda)
    for dtype in (torch.float32, torch.float16):
        tail = lambda: ttail.fused_spatial_tail(  # noqa: E731
            x.to(dtype), o1.to(dtype), ck.to(dtype), cv.to(dtype),
            {k: v.to(dtype) for k, v in tail_params.items()}, heads=1)
        block = lambda: tblock.fused_temporal_block(  # noqa: E731
            xb.to(dtype), {k: v.to(dtype) for k, v in block_params.items()}, heads=8)
        for run in (tail, block):
            if dtype == torch.float32:
                assert run().dtype == torch.float32
            else:
                with pytest.raises(ValueError, match="bfloat16 or float32"):
                    run()


@pytest.mark.parametrize("model", ["zeroscope-tiny", "zeroscope-tiny-hf"])
def test_float32_tiny_unet_runs_on_its_kernels(cuda, model):
    """One CFG UNet call of a float32 test model on the card launches the
    float32 kernels (GroupNorm, the CUDA-core GEGLU pair, and frame-axis
    attention in the diffusers style) and lands within 1e-4 relative RMS of
    the CPU's plain versions (f32 on both sides)."""
    from dvdx_tpu_torch.pipelines.text2video import build_pipeline
    from dvdx_tpu_torch.utils.testing import perturb_zero_params, relative_rms

    cpu = perturb_zero_params(build_pipeline(model, seed=0, device="cpu"), seed=99)
    card = build_pipeline(model, seed=0, device="cuda")
    card.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()})
    z = _randn((2, 4, 4, 4, 4), 0, "cpu")
    ctx = _randn((2, 77, 64), 1, "cpu")
    t = torch.tensor([500, 500])
    before = tgn.F32_LAUNCHES, tff.SIMT_LAUNCHES, ttemp.F32_LAUNCHES
    with torch.inference_mode():
        got = card.unet(z.cuda(), t.cuda(), ctx.cuda()).cpu()
        want = cpu.unet(z, t, ctx)
    assert tgn.F32_LAUNCHES > before[0] and tff.SIMT_LAUNCHES > before[1]
    assert (ttemp.F32_LAUNCHES > before[2]) == (model == "zeroscope-tiny-hf")
    assert relative_rms(got, want) <= 1e-4


def test_bf16_tiny_steps_card_against_cpu(cuda):
    """A measurement of the cross-device gap the validator's cross-platform
    regime (atol 5e-2) must absorb for a bf16 model: zeroscope-tiny in bf16
    records 3 steps on the card (bf16 kernels) and the CPU (plain versions)
    re-executes them from the revealed z. Printed (pytest -rP); asserted
    only finite, with the card's bf16 GroupNorm and GEGLU launched."""
    import dataclasses

    from dvdx_tpu_torch.models.zoo import get_model_spec
    from dvdx_tpu_torch.pipelines.text2video import build_pipeline
    from dvdx_tpu_torch.utils.testing import perturb_zero_params
    from dvdx_tpu_torch.verify.spotcheck import StepEngine, compare_arrays

    tiny = get_model_spec("zeroscope-tiny")
    spec = dataclasses.replace(tiny, unet=dataclasses.replace(tiny.unet, dtype="bfloat16"),
                               vae=dataclasses.replace(tiny.vae, dtype="bfloat16"))
    weights = perturb_zero_params(build_pipeline("zeroscope-tiny", seed=0, device="cpu"),
                                  seed=99).state_dict()
    engines = []
    for dev in ("cuda", "cpu"):
        pipe = build_pipeline(spec, seed=0, device=dev)
        pipe.load_state_dict({k: v.to(dev) for k, v in weights.items()})
        engines.append(StepEngine(pipe))
    before = tgn.LAUNCHES, tff.LAUNCHES + tff.SIMT_LAUNCHES
    _, zs, epss, _ = engines[0].generate_recorded("a blue cube spinning", seed=7, num_frames=4,
                                                  height=32, width=32, num_steps=3,
                                                  guidance_scale=7.5)
    assert tgn.LAUNCHES > before[0] and tff.LAUNCHES + tff.SIMT_LAUNCHES > before[1]
    eps_re, z_re = engines[1].reexecute_steps("a blue cube spinning", "", list(zs), [0, 1, 2],
                                              3, 7.5)
    eps_err = [compare_arrays(eps_re[i], epss[i], bitwise=False, atol=5e-2)[1]
               for i in range(3)]
    z_err = [compare_arrays(z_re[i], zs[i + 1], bitwise=False, atol=5e-2)[1] for i in range(2)]
    print(f"bf16 zeroscope-tiny, card record vs CPU re-execution: eps_err {eps_err} "
          f"z_next_err {z_err} (atol 5e-2) at max|eps| {epss.float().abs().max().item()} "
          f"max|z| {zs.float().abs().max().item()}")
    assert all(np.isfinite(eps_err + z_err))


# --- the XL geometry's new shapes (zeroscope-v2-xl with cfg_split: batch 1,
# 24 frames, latent 72x128), on the slices chip_smoke.py's phase 2 holds ---


@pytest.mark.parametrize("b,s,h,held", [(24, 9216, 5, [0, 23]), (24, 576, 20, None)])
def test_flash_kernel_xl_shapes(cuda, b, s, h, held):
    """Level 0 over 9216 tokens (plain attention over all 120 batch-heads
    would hold 40 GB of logits: frames 0 and 23 are held) and level 2 over
    576 tokens, which flash's gate takes only at XL."""
    q, k, v = (_randn((b, s, h, 64), i, cuda).bfloat16() for i in range(3))
    got = tflash.flash_attention(q, k, v)
    torch.cuda.synchronize()
    if held is not None:
        got, q, k, v = got[held], q[held], k[held], v[held]
    _check(got, tflash.flash_attention_plain(q, k, v))


@pytest.mark.parametrize("heads", [5, 8])
def test_temporal_block_kernel_xl_shape(cuda, heads):
    """F = 24 over 9216 positions: level 0's temporal transformers (5 x 64)
    and transformer_in (8 x 40)."""
    x, params = _temporal_block_args(1, 24, 9216, 320, cuda)
    got = tblock.fused_temporal_block(x, params, heads=heads)
    torch.cuda.synchronize()
    _check(got, tblock.fused_temporal_block_plain(x, params, heads=heads))


def test_spatial_tail_kernel_xl_shape(cuda):
    """Level 0's 24 x 9216 rows."""
    (x, o1, ctx_k, ctx_v), params = _spatial_tail_args(24, 9216, 320, 77, cuda)
    got = ttail.fused_spatial_tail(x, o1, ctx_k, ctx_v, params, heads=5)
    torch.cuda.synchronize()
    _check(got, ttail.fused_spatial_tail_plain(x, o1, ctx_k, ctx_v, params, heads=5))


@pytest.mark.parametrize("n,l,c,act,with_bias,eps", [
    (24, 9216, 320, "silu", True, 1e-5), (1, 221184, 320, "none", False, 1e-6),
    (1, 589824, 256, "silu", False, 1e-6), (1, 589824, 128, "silu", False, 1e-6)])
def test_group_norm_kernel_xl_shapes(cuda, n, l, c, act, with_bias, eps):
    """The UNet's level 0 over 24 frames and the VAE decoder's full 1024x576
    frame (589,824 rows)."""
    x, gamma, beta, bias = _group_norm_args(n, l, c, with_bias, cuda)
    kw = dict(groups=32, eps=eps, act=act, bias=bias)
    got = tgn.group_norm_act(x, gamma, beta, **kw)
    torch.cuda.synchronize()
    _check(got, tgn.group_norm_act_plain(x, gamma, beta, **kw))


# --- the other families' new shapes: cogvideox-5b's joint attention (D 64,
# 48 heads, a ragged 65,026-token sequence at 48 x 720x480, 5,626 at 4
# frames) and svd-img2vid's 25 frames and 1-token image context ---


@pytest.mark.parametrize("b,s,h,rows", [(2, 5626, 4, None),
                                        (1, 65026, 2, [(0, 128), (128, 256), (64896, 65026)])])
def test_flash_kernel_dit_shapes(cuda, b, s, h, rows):
    """The DiT's joint attention, ragged on the query side and the key side;
    at 65,026 tokens held on query-row slices against all keys (tile 0, the
    text / video boundary tile, the last full and partial tiles)."""
    q, k, v = (_randn((b, s, h, 64), i, cuda).bfloat16() for i in range(3))
    got = tflash.flash_attention(q, k, v)
    torch.cuda.synchronize()
    for r0, r1 in rows or [(0, s)]:
        _check(got[:, r0:r1], tflash.flash_attention_plain(q[:, r0:r1], k, v))


@pytest.mark.parametrize("n,s,c,heads", [(2, 2880, 320, 5), (50, 720, 320, 5)])
def test_spatial_tail_kernel_one_token_context(cuda, n, s, c, heads):
    """svd-img2vid's cross-attention over its 1-token image context."""
    (x, o1, ctx_k, ctx_v), params = _spatial_tail_args(n, s, c, 1, cuda)
    got = ttail.fused_spatial_tail(x, o1, ctx_k, ctx_v, params, heads=heads)
    torch.cuda.synchronize()
    _check(got, ttail.fused_spatial_tail_plain(x, o1, ctx_k, ctx_v, params, heads=heads))


@pytest.mark.parametrize("b,f,n,c,heads", [(2, 25, 100, 320, 5), (1, 25, 45, 320, 8)])
def test_temporal_block_kernel_25_frames(cuda, b, f, n, c, heads):
    """svd-img2vid's 25 frames, which do not divide the block's 64-row tiles."""
    x, params = _temporal_block_args(b, f, n, c, cuda)
    got = tblock.fused_temporal_block(x, params, heads=heads)
    torch.cuda.synchronize()
    _check(got, tblock.fused_temporal_block_plain(x, params, heads=heads))


@pytest.mark.parametrize("layout", ["frame_major", "position_major"])
@pytest.mark.parametrize("n,heads,d", [(720, 10, 64), (45, 20, 64)])
def test_temporal_kernel_25_frames(cuda, layout, n, heads, d):
    shape = (2, 25, n, heads * d) if layout == "frame_major" else (2, n, 25, heads * d)
    q, k, v = (_randn(shape, i, cuda).bfloat16() for i in range(3))
    if layout == "frame_major":
        got = ttemp.temporal_attention(q, k, v, heads=heads)
        want = ttemp.temporal_attention_plain(q, k, v, heads=heads)
    else:
        got = ttemp.temporal_attention_posmajor(q, k, v, heads=heads)
        want = ttemp.temporal_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), heads=heads).transpose(1, 2)
    torch.cuda.synchronize()
    _check(got, want)


def test_frame_sharded_groupnorm_on_the_card(cuda):
    """Over one rank the frame-sharded GroupNorm is the fused kernel."""
    x = _randn((2, 8, 64, 64), 3, cuda).bfloat16()
    w, b = _randn((64,), 4, cuda), _randn((64,), 5, cuda)
    before = tgn.LAUNCHES, tgn.MOMENTS_OUT_LAUNCHES, tgn.MOMENTS_IN_LAUNCHES
    got = tgn.group_norm_act_sharded(x, w, b, groups=8, eps=1e-5, act="silu")
    torch.cuda.synchronize()
    assert (tgn.LAUNCHES, tgn.MOMENTS_OUT_LAUNCHES, tgn.MOMENTS_IN_LAUNCHES) == (
        before[0] + 1, before[1], before[2])
    _check(got, tgn.group_norm_act_plain(x, w, b, groups=8, eps=1e-5, act="silu"))


# the UNet's level-0 temporal norm (frames and 2880 positions), a resnet's
# level 2, the 2560-channel concat, a ragged last chunk, and float32 (also
# ragged, and at level 2's frame-sharded temporal conv norm)
GN_SHARDED_SHAPES = [((2, 16, 2880, 320), 32, torch.bfloat16),
                     ((32, 180, 1280), 32, torch.bfloat16),
                     ((4, 45, 2560), 32, torch.bfloat16),
                     ((3, 1000, 320), 32, torch.bfloat16),
                     ((2, 4, 256, 32), 8, torch.float32),
                     ((3, 1000, 320), 32, torch.float32),
                     ((2, 16, 180, 1280), 32, torch.float32)]


@pytest.mark.parametrize("shape,groups,dtype", GN_SHARDED_SHAPES)
def test_group_norm_moments_out_kernel(cuda, shape, groups, dtype):
    """Moments-out: the float32 mean and E[x^2] of the kernel's float64 sums
    equal the plain version's (``_moment_sums``) bit for bit, and a second
    call gives the same bits."""
    x = _randn(shape, 7, cuda, 2.0, 0.5).to(dtype)
    before = tgn.MOMENTS_OUT_LAUNCHES
    sums, count = tgn.group_norm_moments(x, groups)
    torch.cuda.synchronize()
    assert tgn.MOMENTS_OUT_LAUNCHES == before + 1
    ref, ref_count = tgn._moment_sums(x.reshape(shape[0], -1, shape[-1]).float(), groups)
    assert sums.shape == (2, shape[0], groups) and count == ref_count
    assert torch.equal((sums / count).float(), (ref / ref_count).float())
    assert torch.equal(sums, tgn.group_norm_moments(x, groups)[0])


def test_group_norm_moments_out_leaves_its_tickets_clean(cuda):
    """Moments-out's last block of each sample sets its ticket back to 0:
    launches back to back on one stream, with no synchronisation between
    them, at two shapes (192 and 20 chunks a sample), give the first
    launch's bits again."""
    x = _randn((2, 16, 2880, 320), 11, cuda, 2.0, 0.5).bfloat16()
    y = _randn((3, 1000, 320), 12, cuda, 2.0, 0.5).bfloat16()
    runs = [tgn.group_norm_moments(t, 32)[0] for t in (x, x, y, x, y)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[3])
    assert torch.equal(runs[2], runs[4])


@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("shape,groups,dtype", GN_SHARDED_SHAPES)
def test_group_norm_moments_in_kernel(cuda, shape, groups, dtype, act):
    """Moments-in against the plain version given the same moments (2 bf16
    ulps of the output's scale; float32 1e-5 relative), the same bits on a
    second call; and the frames split in two halves (moments-out of each,
    added, moments-in of each) against the whole."""
    x = _randn(shape, 8, cuda, 2.0, 0.5).to(dtype)
    c = shape[-1]
    w, b = _randn((c,), 9, cuda, 0.5, 1.0), _randn((c,), 10, cuda, 0.1)
    kw = dict(groups=groups, eps=1e-6, act=act)
    sums, count = tgn.group_norm_moments(x, groups)
    moments = tuple((sums / count).float())
    before = tgn.MOMENTS_IN_LAUNCHES
    got = tgn.group_norm_apply(x, w, b, moments, **kw)
    torch.cuda.synchronize()
    assert tgn.MOMENTS_IN_LAUNCHES == before + 1
    want = tgn.group_norm_act_plain(x, w, b, moments=moments, **kw)
    if dtype == torch.float32:
        _check_f32(got, want, 1e-5)
    else:
        _check(got, want)
    assert torch.equal(got, tgn.group_norm_apply(x, w, b, moments, **kw))
    halves = x.chunk(2, dim=1)
    parts = [tgn.group_norm_moments(h.contiguous(), groups) for h in halves]
    split = tuple(((parts[0][0] + parts[1][0]) / (parts[0][1] + parts[1][1])).float())
    assert torch.equal(torch.stack(split), torch.stack(moments))
    halved = torch.cat([tgn.group_norm_apply(h.contiguous(), w, b, split, **kw)
                        for h in halves], dim=1)
    if dtype == torch.float32:
        _check_f32(halved, want, 1e-5)
    else:
        _check(halved, want)


def test_blend_chunks_on_the_card(cuda):
    """The float32 blend's index_add_ on the card: the CPU's values within
    float32 rounding, and the same bits on a second call (deterministic
    algorithms on)."""
    from dvdx_tpu_torch import enable_determinism
    from dvdx_tpu_torch.parallel.chunking import blend_chunks, plan_chunks

    enable_determinism()
    plan = plan_chunks(16, 2, 2)
    chunks = _randn((1, 2, 9, 40, 72, 4), 6, torch.device("cpu"))
    ref = blend_chunks(chunks, plan)
    got = blend_chunks(chunks.to(cuda), plan)
    assert torch.equal(got, blend_chunks(chunks.to(cuda), plan))
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-6)
