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
