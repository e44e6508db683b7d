#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``dvdx_tpu_torch``) on one GPU.

    python3 chip_smoke.py    # needs one CUDA card

Phases, each printing on its own lines; any failure raises and exits nonzero:
  1. the card's name and power limit (nvidia-smi), torch / CUDA versions;
     determinism flags set;
  2. build of every CUDA kernel from ``dvdx_tpu_torch/csrc`` (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the card, in bf16, at
     the main path's full-width shapes (and a few off it: the fused tail at
     C = 384, with tiles spanning two images, at T = 300, at C = 64 with T =
     16, at head width 40 and at C = 640 (the wide chain); frame-axis
     attention at 24-128 frames with head widths 40 / 64 / 128 in both
     layouts; flash_attention_mh, GEGLU's two launches on their own at level
     2, GroupNorm with a level-0 pre-bias and with ragged chunks, the fused
     block at a ragged N and at F = 24), with kernel / plain / library times
     (CUDA events, the launches queued behind a device spin), the roofline
     bound (the fused kernels' also split into their chain and FF launches),
     and a second call that must give the same bits;
  4. the reference check: one UNet call of a small model of the same
     structure on the card (kernels) and on the CPU (plain versions) from
     the same weights and inputs, every kernel of the model path launched;
     the base noise's bits on the card and on the CPU;
  5. the main path: zeroscope-v2-576w with seeded random weights (zero-init
     leaves perturbed so every layer carries signal). Request A: 16 frames at
     576x320, 25 DDIM steps, CFG 7.5, PoI recording, Merkle root; every
     kernel of the model path must have launched, as often per UNet call as
     the layers' routing says. Request B: another prompt and seed, 3 steps,
     run twice; leaves and roots must be bit-identical. The validator's
     re-execution (``verify.spotcheck.StepEngine``) of 3 revealed steps of
     Request A must reproduce them bit for bit, bind the video, and refuse a
     tampered eps leaf. Then each kernel's bound summed over one UNet call
     and one frame's VAE decode, from the shapes its layers hand it;
  6. a ``kernels`` JSON line, then the result line.

Imports nothing of JAX or of the JAX package. Detail too long for the end of
the output goes to ``chiprun_out/``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
OUT_DIR = "chiprun_out"


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Device milliseconds per call: the launches are queued while the
    device spins for about 20 ms, so a call whose host side is slower than
    its kernels (small shapes) is timed by its kernels, not by the host."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def randn(shape, gen, scale=1.0, shift=0.0):
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    return (x * scale + shift).to(torch.bfloat16)


# (flops, bytes) of one launch: each input read once, each output written
# once, bf16 activations and weights
def flash_cost(b, s, h, d):
    return 4.0 * b * h * s * s * d, 4.0 * b * s * h * d * 2


def temporal_cost(b, f, n, h, d):
    return 4.0 * b * n * h * f * f * d, 4.0 * b * f * n * h * d * 2


def geglu_cost(t, c, inner):
    return 6.0 * t * c * inner, (2.0 * t * c + 3.0 * c * inner + 2 * inner + c) * 2


def geglu_in_cost(t, c, inner):
    return 4.0 * t * c * inner, (t * c + 2.0 * inner * c + 2 * inner + t * inner) * 2


def geglu_out_cost(t, c, inner):
    return 2.0 * t * c * inner, (t * inner + 1.0 * c * inner + c + t * c) * 2


def flash_mh_cost(b, sq, sk, h, d):
    # q, k, v read at their head_dim lanes; the padded (B, Sq, H*128) output
    # written once
    return 4.0 * b * h * sq * sk * d, (b * (sq + 2 * sk) * h * d + b * sq * h * 128) * 2.0


def spatial_tail_cost(rows, c, hd1, hd, t, n):
    flops = 2.0 * rows * (3 * hd * c + 2 * t * hd + 12 * c * c)
    weights = 3 * hd * c + 12 * c * c + 13 * c  # matrices, biases, LN vectors
    return flops, (rows * (2 * c + hd1) + weights + 2 * n * t * hd) * 2.0


def spatial_chain_cost(rows, c, hd, t, n):
    # the chain launch: three C x C products and the cross-attention (S and
    # P.V over T tokens, 2 T HD multiply-adds a row); x and o1 read, x2 and h
    # written, the three weights, six bias / LN vectors and the context K / V
    # read once
    return (2.0 * rows * (3 * c * hd + 2 * t * hd),
            (4 * rows * c + 3 * c * hd + 6 * c + 2 * n * t * hd) * 2.0)


def temporal_chain_cost(rows, f, c):
    # the chain launch: eight C x C products and two attentions (S and P.V,
    # 2 F C multiply-adds a row each); x and 8 C^2 weights and 8 LN / bias
    # vectors read, x_mid and h written
    return 2.0 * rows * (8 * c * c + 4 * f * c), (3 * rows * c + 8 * c * c + 8 * c) * 2.0


def temporal_ff_cost(rows, c):
    # the two GEGLU launches: h read, the (rows, 4C) inner tensor written and
    # read back, x_mid read, out written
    flops, _ = geglu_cost(rows, c, 4 * c)
    return flops, (2 * rows * c + 2 * rows * 4 * c + rows * c + 12 * c * c + 9 * c) * 2.0


def temporal_block_cost(rows, f, c):
    # the whole block as one function: x read, out written, weights once
    flops = 2.0 * rows * (8 * c * c + 4 * f * c + 12 * c * c)
    return flops, (2 * rows * c + 20 * c * c + 15 * c) * 2.0


def gn_cost(n, l, c, bias):
    # x read, y written (bf16), the (N, C) bias (bf16), gamma and beta (f32)
    return 8.0 * n * l * c, 2.0 * n * l * c * 2 + (n * c * 2 if bias else 0) + 8 * c


# --- phase 3: kernels against their plain versions --------------------------

def kernel_cases():
    """(kernel, label, inputs(gen), kernel_fn, plain_fn, library_fn, (flops,
    bytes), on the main path) at the standard geometry (CFG batch 2, 16
    frames, latent 40x72) and, for GroupNorm, the VAE decoder's frames."""
    import torch.nn.functional as F

    from dvdx_tpu_torch.ops import groupnorm as gn
    from dvdx_tpu_torch.ops.kernels import flash_attention as fa
    from dvdx_tpu_torch.ops.kernels import geglu_ff as gf
    from dvdx_tpu_torch.ops.kernels import spatial_tail as st
    from dvdx_tpu_torch.ops.kernels import temporal_attention as ta
    from dvdx_tpu_torch.ops.kernels import temporal_block as tb

    cases = []

    def sdpa_bshd(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))

    for label, (b, s, h, d) in (("level0", (32, 2880, 5, 64)),
                                ("level1", (32, 720, 10, 64)),
                                ("ragged_d40", (4, 777, 3, 40))):
        def mk(gen, b=b, s=s, h=h, d=d):
            return [randn((b, s, h, d), gen) for _ in range(3)]
        main = label != "ragged_d40"
        cases.append(("flash_attention", label, mk, fa.flash_attention,
                      fa.flash_attention_plain, sdpa_bshd, flash_cost(b, s, h, d), main))

    def sdpa_fm(heads):
        def fn(q, k, v):
            b, f, n, hd = q.shape
            d = hd // heads
            t = [x.view(b, f, n, heads, d).permute(0, 2, 3, 1, 4) for x in (q, k, v)]
            return F.scaled_dot_product_attention(*t)
        return fn

    # the main path's four frame-major shapes, then off it: level 0 and
    # transformer_in's shapes (the fused block takes them on the path), the
    # position-major layout, and longer clips (up to the kernel's 128
    # frames) at head widths 40, 64 and 128 in both layouts
    long_clips = tuple(
        (f"f{f}_{h}x{d}" + ("_posmajor" if layout == "pm" else ""), (2, f, 180, h, d), layout)
        for f in (24, 40, 64, 128) for h, d in ((8, 40), (5, 64), (3, 128))
        for layout in ("fm", "pm"))
    for label, (b, f, n, heads, d), layout in (
            ("level0", (2, 16, 2880, 5, 64), "fm"),
            ("transformer_in_d40", (2, 16, 2880, 8, 40), "fm"),
            ("level1", (2, 16, 720, 10, 64), "fm"),
            ("level2", (2, 16, 180, 20, 64), "fm"),
            ("level3", (2, 16, 45, 20, 64), "fm"),
            ("level0_posmajor", (2, 16, 2880, 5, 64), "pm"),
            ("transformer_in_d40_posmajor", (2, 16, 2880, 8, 40), "pm")) + long_clips:
        shape = (b, f, n, heads * d) if layout == "fm" else (b, n, f, heads * d)

        def mk(gen, shape=shape):
            return [randn(shape, gen) for _ in range(3)]
        if layout == "fm":
            kern = lambda q, k, v, h=heads: ta.temporal_attention(q, k, v, heads=h)
            plain = lambda q, k, v, h=heads: ta.temporal_attention_plain(q, k, v, heads=h)
            lib = sdpa_fm(heads)
        else:
            kern = lambda q, k, v, h=heads: ta.temporal_attention_posmajor(q, k, v, heads=h)
            plain = lambda q, k, v, h=heads: ta.temporal_attention_plain(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                heads=h).transpose(1, 2)
            lib = lambda q, k, v, h=heads: sdpa_fm(h)(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        cases.append(("temporal_attention", label, mk, kern, plain, lib,
                      temporal_cost(b, f, n, heads, d),
                      label in ("level0", "transformer_in_d40", "level1", "level2", "level3")))

    for label, (t, c) in (("level0", (92160, 320)), ("level1", (23040, 640)),
                          ("level2", (5760, 1280)), ("level3", (1440, 1280))):
        inner = 4 * c

        def mk(gen, t=t, c=c, inner=inner):
            return [randn((t, c), gen), randn((2 * inner, c), gen, c ** -0.5),
                    randn((2 * inner,), gen, 0.1), randn((c, inner), gen, inner ** -0.5),
                    randn((c,), gen, 0.1)]
        cases.append(("geglu_ff", label, mk, gf.geglu_ff, gf.geglu_ff_plain, None,
                      geglu_cost(t, c, inner), True))

    # the two launches of the level-2 call on their own, so each one's time
    # shows (geglu_ff's row above is their sum)
    t, c, inner = 5760, 1280, 5120
    cases.append(("geglu_ff", "level2_geglu_in",
                  lambda gen, t=t, c=c, inner=inner: [
                      randn((t, c), gen), randn((2 * inner, c), gen, c ** -0.5),
                      randn((2 * inner,), gen, 0.1)],
                  gf.geglu_in, gf.geglu_in_plain, None, geglu_in_cost(t, c, inner), False))
    cases.append(("geglu_ff", "level2_geglu_out",
                  lambda gen, t=t, c=c, inner=inner: [
                      randn((t, inner), gen), randn((c, inner), gen, inner ** -0.5),
                      randn((c,), gen, 0.1)],
                  gf.geglu_out, gf.geglu_out_plain, None, geglu_out_cost(t, c, inner), False))

    # UNet norms (eps 1e-5, 1e-6 in the transformers), then the VAE decoder's
    # per-frame norms at 576x320 (eps 1e-6, one sample, up to 737k elements
    # per group); the VAE inputs sit at mean 3 std 1, where one-pass moments
    # cancel most
    for label, (n, l, c, act, bias, eps, scale, shift) in (
            ("resnet_l0", (32, 2880, 320, "silu", True, 1e-5, 2.0, 0.5)),
            ("temporal_l0", (2, 46080, 320, "none", False, 1e-6, 2.0, 0.5)),
            ("resnet_l1", (32, 720, 640, "silu", False, 1e-5, 2.0, 0.5)),
            ("resnet_l2", (32, 180, 1280, "silu", True, 1e-5, 2.0, 0.5)),
            ("resnet_l3_concat", (32, 45, 2560, "silu", False, 1e-5, 2.0, 0.5)),
            ("temporal_l0_bias", (2, 46080, 320, "none", True, 1e-6, 2.0, 0.5)),
            ("ragged_chunks", (3, 1000, 320, "silu", True, 1e-5, 2.0, 0.5)),
            ("vae_mid", (1, 2880, 512, "silu", False, 1e-6, 1.0, 3.0)),
            ("vae_mid_attn", (1, 2880, 512, "none", False, 1e-6, 1.0, 3.0)),
            ("vae_up_80x144", (1, 11520, 512, "silu", False, 1e-6, 1.0, 3.0)),
            ("vae_up_160x288_c512", (1, 46080, 512, "silu", False, 1e-6, 1.0, 3.0)),
            ("vae_up_160x288", (1, 46080, 256, "silu", False, 1e-6, 1.0, 3.0)),
            ("vae_up_320x576_c256", (1, 184320, 256, "silu", False, 1e-6, 1.0, 3.0)),
            ("vae_out_320x576", (1, 184320, 128, "silu", False, 1e-6, 1.0, 3.0))):
        def mk(gen, n=n, l=l, c=c, bias=bias, scale=scale, shift=shift):
            xs = [randn((n, l, c), gen, scale, shift),
                  torch.rand((c,), generator=gen, device="cuda") + 0.5,
                  torch.randn((c,), generator=gen, device="cuda") * 0.1]
            xs.append(randn((n, c), gen) if bias else None)
            return xs

        def kern(x, w, b_, bias, act=act, eps=eps):
            return gn.group_norm_act(x, w, b_, groups=32, eps=eps, act=act, bias=bias)

        def plain(x, w, b_, bias, act=act, eps=eps):
            return gn.group_norm_act_plain(x, w, b_, groups=32, eps=eps, act=act,
                                           bias=bias)

        def lib(x, w, b_, bias, act=act, eps=eps):
            xb = x if bias is None else x + bias[:, None, :]
            y = F.group_norm(xb.transpose(1, 2), 32, w.to(x.dtype), b_.to(x.dtype), eps)
            return F.silu(y) if act == "silu" else y
        cases.append(("group_norm_act", label, mk, kern, plain, lib,
                      gn_cost(n, l, c, bias), label not in GN_OFF_PATH))

    def sdpa_mh(heads, d):
        def fn(q, k, v):
            t = [fa._head_views(x, heads, d).transpose(1, 2) for x in (q, k, v)]
            return F.scaled_dot_product_attention(*t)
        return fn

    # flash_attention_mh (off the main path): head strips of 128 lanes
    for label, (b, sq, sk, heads, d) in (("self_level0", (32, 2880, 2880, 5, 64)),
                                         ("cross_77", (32, 2880, 77, 5, 64))):
        def mk(gen, b=b, sq=sq, sk=sk, heads=heads, d=d):
            out = []
            for s_ in (sq, sk, sk):
                x = torch.zeros((b, s_, heads, 128), device="cuda", dtype=torch.bfloat16)
                x[..., :d] = randn((b, s_, heads, d), gen)
                out.append(x.view(b, s_, heads * 128))
            return out
        cases.append(("flash_attention_mh", label, mk,
                      lambda q, k, v, h=heads, d=d: fa.flash_attention_mh(q, k, v, heads=h, head_dim=d),
                      lambda q, k, v, h=heads, d=d: fa.flash_attention_mh_plain(
                          q, k, v, heads=h, head_dim=d),
                      sdpa_mh(heads, d), flash_mh_cost(b, sq, sk, heads, d), False))

    def linear_params(keys, shapes, gen):
        # weights N(0, 1/fan_in), biases and LayerNorm biases N(0, 0.1^2),
        # LayerNorm scales 1 + N(0, 0.1^2)
        out = {}
        for key in keys:
            shape = shapes[key]
            if len(shape) == 2:
                out[key] = randn(shape, gen, shape[1] ** -0.5)
            else:
                out[key] = randn(shape, gen, 0.1, 1.0 if key.endswith("_s") else 0.0)
        return out

    # the main path's level 0, then off it: C = 384 (two ring stages), S =
    # 721 (tiles spanning two images), T = 300 (two sweeps over 128-token
    # fills), C = 64 with T = 16, head width 40, and C = 640 (the wide chain)
    for label, (n, s_, c, heads, t), main in (("level0", (32, 2880, 320, 5, 77), True),
                                              ("c384", (8, 2880, 384, 6, 77), False),
                                              ("s721_spanning", (32, 721, 320, 5, 77), False),
                                              ("t300_two_sweeps", (8, 2880, 320, 5, 300), False),
                                              ("c64_t16", (8, 1024, 64, 1, 16), False),
                                              ("d40", (8, 2880, 320, 8, 77), False),
                                              ("c640", (32, 720, 640, 10, 77), False)):
        shapes = {k: (c,) for k in st.KEYS}
        shapes.update({"o1_w": (c, c), "q2_w": (c, c), "o2_w": (c, c),
                       "ffi_w": (8 * c, c), "ffi_b": (8 * c,), "ffo_w": (c, 4 * c)})

        def mk(gen, n=n, s_=s_, c=c, t=t, shapes=shapes):
            return [randn((n, s_, c), gen), randn((n, s_, c), gen),
                    randn((n, t, c), gen), randn((n, t, c), gen),
                    linear_params(st.KEYS, shapes, gen)]
        cases.append(("fused_spatial_tail", label, mk,
                      lambda *a, h=heads: st.fused_spatial_tail(*a, heads=h),
                      lambda *a, h=heads: st.fused_spatial_tail_plain(*a, heads=h), None,
                      spatial_tail_cost(n * s_, c, c, c, t, n), main))
        BOUND_PARTS[("fused_spatial_tail", label)] = {
            "chain": bound_ms(*spatial_chain_cost(n * s_, c, c, t, n))[0],
            "ff": bound_ms(*temporal_ff_cost(n * s_, c))[0]}

    # the main path's two blocks, then off it: N not a multiple of the 4
    # positions a tile, and F = 24 (the XL geometry's frames: 2 positions a
    # tile, keys padded to 32) with both head layouts
    for label, (b, f, n, heads) in (("level0", (2, 16, 2880, 5)),
                                    ("transformer_in_d40", (2, 16, 2880, 8)),
                                    ("f16_ragged_n", (2, 16, 2881, 5)),
                                    ("f24_5x64", (2, 24, 2881, 5)),
                                    ("f24_8x40", (2, 24, 2881, 8))):
        c = 320
        shapes = {k: (c,) for k in tb.KEYS}
        shapes.update({k: (c, c) for k in ("q1", "k1", "v1", "o1_w", "q2", "k2", "v2", "o2_w")})
        shapes.update({"ffi_w": (8 * c, c), "ffi_b": (8 * c,), "ffo_w": (c, 4 * c)})

        def mk(gen, b=b, f=f, n=n, c=c, shapes=shapes):
            return [randn((b, f, n, c), gen), linear_params(tb.KEYS, shapes, gen)]
        cases.append(("fused_temporal_block", label, mk,
                      lambda x, p, h=heads: tb.fused_temporal_block(x, p, heads=h),
                      lambda x, p, h=heads: tb.fused_temporal_block_plain(x, p, heads=h), None,
                      temporal_block_cost(b * f * n, f, c), label in ("level0",
                                                                      "transformer_in_d40")))
        BOUND_PARTS[("fused_temporal_block", label)] = {
            "chain": bound_ms(*temporal_chain_cost(b * f * n, f, c))[0],
            "ff": bound_ms(*temporal_ff_cost(b * f * n, c))[0]}
    return cases


GN_OFF_PATH = ("temporal_l0_bias", "ragged_chunks")
# (kernel, shape label) -> the bound of each launch group of a fused kernel
BOUND_PARTS = {}


KERNEL_META = {
    "flash_attention": ("dvdx_tpu_torch/csrc/flash_attention.cu",
                        "dvdx_tpu/ops/pallas/flash_attention.py:470"),
    "temporal_attention": ("dvdx_tpu_torch/csrc/temporal_attention.cu",
                           "dvdx_tpu/ops/pallas/temporal_attention.py:183"),
    "geglu_ff": ("dvdx_tpu_torch/csrc/geglu_ff.cu",
                 "dvdx_tpu/ops/pallas/geglu_ff.py:98"),
    "group_norm_act": ("dvdx_tpu_torch/csrc/groupnorm.cu",
                       "dvdx_tpu/ops/groupnorm.py:179"),
    "flash_attention_mh": ("dvdx_tpu_torch/csrc/flash_attention.cu",
                           "dvdx_tpu/ops/pallas/flash_attention.py:361"),
    "fused_spatial_tail": ("dvdx_tpu_torch/csrc/spatial_tail.cu",
                           "dvdx_tpu/ops/pallas/spatial_tail.py:304"),
    "fused_temporal_block": ("dvdx_tpu_torch/csrc/temporal_block.cu",
                             "dvdx_tpu/ops/pallas/temporal_block.py:146"),
}
# the kernels the UNet / VAE path runs (flash_attention_mh is opt-in in the
# JAX package and off the port's path: phase 3 alone holds it)
MODEL_PATH = ("flash_attention", "temporal_attention", "geglu_ff", "group_norm_act",
              "fused_spatial_tail", "fused_temporal_block")
# launches per batched UNet call of zeroscope-v2-576w at 16 x 576x320: flash
# in the 10 spatial transformers of levels 0-1 (S >= 512), the fused tail in
# the 5 of level 0, the fused block in transformer_in and the 5 level-0
# temporal transformers, frame-axis attention twice in each of the 11 other
# temporal transformers, GEGLU in the 11 other spatial and 11 other temporal
# transformers, GroupNorm in every resnet, temporal conv and transformer
EXPECTED_PER_UNET_CALL = {"flash_attention": 10, "temporal_attention": 22,
                          "geglu_ff": 22, "group_norm_act": 166,
                          "fused_spatial_tail": 5, "fused_temporal_block": 6}
# max |kernel - plain| <= TOL_ULPS bf16 ulps (2^-7 relative) of max |plain|:
# both round to bf16 at the same points but sum in different orders, and the
# flash kernel rounds unnormalised probabilities (the plain version rounds
# normalised ones)
TOL_ULPS = 2.0


def check_kernels():
    """Each case's kernel against its plain version. Returns ({kernel: sums
    over its main-path shapes, or over all its shapes where none is on the
    path}, rows)."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    sums = {}
    rows = []
    for name, label, mk, kern, plain, lib, (flops, nbytes), main in kernel_cases():
        inputs = mk(gen)
        out = kern(*inputs)
        torch.cuda.synchronize()
        ref = plain(*inputs)
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = TOL_ULPS * 2.0 ** -7 * max(scale, 1e-6)
        # the same inputs again must give the same bits (PoI re-execution)
        repeat = torch.equal(out.view(torch.int16), kern(*inputs).view(torch.int16))
        ok = bool(np.isfinite(err)) and err <= tol and repeat
        iters = 5
        ms = cuda_ms(lambda: kern(*inputs), iters)
        plain_ms = cuda_ms(lambda: plain(*inputs), 2)
        lib_ms = cuda_ms(lambda: lib(*inputs), iters) if lib is not None else None
        bms, bby = bound_ms(flops, nbytes)
        parts = BOUND_PARTS.get((name, label))
        row = dict(kernel=name, shape=label, max_abs_err=err, tol=tol,
                   max_abs_ref=scale, repeat_bitwise=repeat, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bms, bound_by=bby, main_path=main, ok=ok,
                   bound_ms_parts=parts)
        rows.append(row)
        log(f"kernel {name:20s} {label:28s} err={err:.3e} tol={tol:.3e} "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={'n/a' if lib_ms is None else f'{lib_ms:.4f}'} "
            f"bound_ms={bms:.4f} ({bby}) repeat_bitwise={repeat} {'OK' if ok else 'FAIL'}"
            + ("" if parts is None else " bound_ms_parts=" + json.dumps(parts)))
        del inputs, out, ref
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"{name} {label}: kernel disagrees with its plain "
                                 f"version ({err:.3e} > {tol:.3e}) or with itself "
                                 f"(repeat bitwise: {repeat})")
        s = sums.setdefault((name, main), dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                               bound_ms=0.0, library_ms=0.0,
                                               t_ops=0.0, t_bytes=0.0))
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["ms"] += ms
        s["plain_ms"] += plain_ms
        s["bound_ms"] += bms
        s["t_ops"] += flops / PEAK_BF16_FLOPS
        s["t_bytes"] += nbytes / PEAK_BYTES
        s["library_ms"] = None if lib_ms is None or s["library_ms"] is None \
            else s["library_ms"] + lib_ms
    summary = {}
    for name in KERNEL_META:
        s = sums.get((name, True)) or sums[(name, False)]
        off = sums.get((name, False))
        if off is not None:
            s["max_abs_err"] = max(s["max_abs_err"], off["max_abs_err"])
        summary[name] = s
    return summary, rows


# --- phase 4: the main path ---------------------------------------------------

def launch_counters():
    """{kernel: (module, name of its launch counter)} for every kernel."""
    from dvdx_tpu_torch.ops import groupnorm as gn
    from dvdx_tpu_torch.ops.kernels import flash_attention as fa
    from dvdx_tpu_torch.ops.kernels import geglu_ff as gf
    from dvdx_tpu_torch.ops.kernels import spatial_tail as st
    from dvdx_tpu_torch.ops.kernels import temporal_attention as ta
    from dvdx_tpu_torch.ops.kernels import temporal_block as tb

    return {"flash_attention": (fa, "LAUNCHES"), "temporal_attention": (ta, "LAUNCHES"),
            "geglu_ff": (gf, "LAUNCHES"), "group_norm_act": (gn, "LAUNCHES"),
            "flash_attention_mh": (fa, "MH_LAUNCHES"),
            "fused_spatial_tail": (st, "LAUNCHES"),
            "fused_temporal_block": (tb, "LAUNCHES")}


def read_counts() -> dict:
    return {k: getattr(m, a) for k, (m, a) in launch_counters().items()}


def reset_counts() -> None:
    for m, a in launch_counters().values():
        setattr(m, a, 0)


def check_against_cpu():
    """The port's CUDA path (its kernels) against its CPU path (the plain
    versions, which the CPU tests hold to the JAX package): the
    full-geometry base noise has the same bits on the card and on the CPU,
    and one batched CFG UNet call of a small model of the same structure
    (``utils.testing.reference_check_pipeline``: C = 64 / 128, level-0
    self-attention over 1024 tokens, mid block at 4x4 latents, so every
    kernel of the model path runs), bf16 on both
    sides, from the same weights and inputs, stays within
    ``REFERENCE_RELRMS_TOL``. One call, not a denoise loop: guidance and the
    sampler amplify each bf16 rounding difference from step to step."""
    from dvdx_tpu_torch.ops import rng
    from dvdx_tpu_torch.utils.testing import (REFERENCE_RELRMS_TOL,
                                              reference_check_inputs,
                                              reference_check_pipeline,
                                              relative_rms, unet_pair_call)

    key = rng.base_key(7)
    gpu_noise = rng.video_noise(key, 16, (40, 72, 4), device="cuda").cpu()
    cpu_noise = rng.video_noise(key, 16, (40, 72, 4), device="cpu")
    ulps = (gpu_noise.view(torch.int32).long() - cpu_noise.view(torch.int32).long()).abs()
    same16 = torch.equal(gpu_noise.bfloat16().view(torch.int16),
                         cpu_noise.bfloat16().view(torch.int16))
    log(f"reference: base noise (16, 40, 72, 4) card vs CPU: {int((ulps > 0).sum())} "
        f"float32 values differ, by up to {int(ulps.max())} ulp; bf16 latent "
        f"bit-equal: {same16}")
    if not same16 or ulps.max() > 3:
        raise AssertionError("base noise differs between the card and the CPU")

    cpu = reference_check_pipeline()
    z, hidden, t = reference_check_inputs(cpu)
    reset_counts()
    eps_gpu = unet_pair_call(reference_check_pipeline(device="cuda").unet,
                             z.cuda(), hidden.cuda(), t).cpu()
    counts = read_counts()
    log(f"reference: small model launches {json.dumps(counts)}")
    missing = [k for k in MODEL_PATH if counts[k] == 0]
    if missing:
        raise AssertionError(f"small model never launched: {missing}")
    eps_cpu = unet_pair_call(cpu.unet, z, hidden, t)
    eps_f32 = unet_pair_call(reference_check_pipeline("float32").unet, z, hidden, t)
    dist = relative_rms(eps_gpu, eps_cpu)
    log(f"reference: small model, one UNet call at t={t}, relative RMS: card vs "
        f"CPU (both bf16) {dist:.5f} (tolerance {REFERENCE_RELRMS_TOL}); card vs "
        f"CPU float32 {relative_rms(eps_gpu, eps_f32):.5f}; CPU bf16 vs CPU "
        f"float32 {relative_rms(eps_cpu, eps_f32):.5f}; max |card - CPU| "
        f"{(eps_gpu - eps_cpu).abs().max().item():.4f} at max |eps| "
        f"{eps_cpu.abs().max().item():.3f}")
    if not dist <= REFERENCE_RELRMS_TOL:
        raise AssertionError(f"the card's UNet call is {dist:.4f} (relative RMS) from "
                             f"the CPU's, over {REFERENCE_RELRMS_TOL}")


def launch_bounds(module, run):
    """Run ``run()`` with forward hooks on the layers of ``module`` that hand
    work to a kernel, and sum each kernel's launches and bound from the
    shapes handed to it: {kernel: {"launches": n, "bound_ms": t}}. Each
    hook's count must equal its kernel's own launch counter over the run."""
    from dvdx_tpu_torch.models import layers
    from dvdx_tpu_torch.ops.attention import wants_flash

    acc = {k: [0, 0.0] for k in MODEL_PATH}
    chain_ff = [0.0, 0.0]  # the fused block's bound split: chain launch, FF launches
    tail_chain_ff = [0.0, 0.0]  # the fused tail's

    def add(name, cost):
        acc[name][0] += 1
        acc[name][1] += bound_ms(*cost)[0]

    def on_gn(mod, args, kwargs, out):
        x, c = args[0], args[0].shape[-1]
        bias = kwargs.get("bias", args[1] if len(args) > 1 else None)
        add("group_norm_act", gn_cost(x.shape[0], x[0].numel() // c, c, bias is not None))

    def on_ff(mod, args, kwargs, out):
        c = args[0].shape[-1]
        add("geglu_ff", geglu_cost(args[0].numel() // c, c, mod.proj_out.in_features))

    def on_frame_attn(mod, args, kwargs, out):
        b, f, n = args[0].shape[:3]
        d = mod.to_q.out_features // mod.heads
        if layers.temporal_attention_wants(f, d):
            add("temporal_attention", temporal_cost(b, f, n, mod.heads, d))

    def on_attn(mod, args, kwargs, out):
        x = args[0]
        ctx = kwargs.get("context", args[1] if len(args) > 1 else None)
        s = x.shape[1]
        if wants_flash(s, s if ctx is None else ctx.shape[1], mod.head_dim):
            add("flash_attention", flash_cost(x.shape[0], s, mod.heads, mod.head_dim))

    def on_block(mod, args, kwargs, out):
        # the fused tail calls attn1.attend, not its forward
        x, ctx = args[0], kwargs.get("context", args[1] if len(args) > 1 else None)
        if not mod.fused(x, ctx):
            return
        n, s, c = x.shape
        a1 = mod.attn1
        if wants_flash(s, s, a1.head_dim):
            add("flash_attention", flash_cost(n, s, a1.heads, a1.head_dim))
        hd = mod.attn2.to_q.out_features
        add("fused_spatial_tail", spatial_tail_cost(n * s, c, a1.heads * a1.head_dim,
                                                    hd, ctx.shape[1], n))
        tail_chain_ff[0] += bound_ms(*spatial_chain_cost(n * s, c, hd, ctx.shape[1], n))[0]
        tail_chain_ff[1] += bound_ms(*temporal_ff_cost(n * s, c))[0]

    def on_temporal_block(mod, args, kwargs, out):
        x = args[0]
        if mod.fused(x):
            rows, f, c = x[..., 0].numel(), x.shape[1], x.shape[-1]
            add("fused_temporal_block", temporal_block_cost(rows, f, c))
            chain_ff[0] += bound_ms(*temporal_chain_cost(rows, f, c))[0]
            chain_ff[1] += bound_ms(*temporal_ff_cost(rows, c))[0]

    hooks = ((layers.GroupNorm, on_gn), (layers.GEGLUFeedForward, on_ff),
             (layers._FrameAxisAttention, on_frame_attn), (layers.Attention, on_attn),
             (layers.BasicTransformerBlock, on_block),
             (layers._TemporalBlock, on_temporal_block))
    handles = [m.register_forward_hook(fn, with_kwargs=True)
               for m in module.modules() for cls, fn in hooks if isinstance(m, cls)]
    before = read_counts()
    run()
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    after = read_counts()
    for k, (n, _) in acc.items():
        if after[k] - before[k] != n:
            raise AssertionError(f"{k}: {after[k] - before[k]} launches, "
                                 f"{n} seen by the bound's hooks")
    out = {k: {"launches": n, "bound_ms": ms} for k, (n, ms) in acc.items()}
    out["fused_temporal_block"].update(bound_ms_chain=chain_ff[0], bound_ms_ff=chain_ff[1])
    out["fused_spatial_tail"].update(bound_ms_chain=tail_chain_ff[0],
                                     bound_ms_ff=tail_chain_ff[1])
    return out


def run_path(steps_a: int):
    from dvdx_tpu_torch.ops import rng
    from dvdx_tpu_torch.ops.scheduler import make_ddim_schedule
    from dvdx_tpu_torch.pipelines.text2video import (build_pipeline, encode_prompts,
                                                     generate)
    from dvdx_tpu_torch.utils.testing import perturb_zero_params, unet_pair_call
    from dvdx_tpu_torch.verify.merkle import MerkleCommitment

    t0 = time.perf_counter()
    pipe = build_pipeline("zeroscope-v2-576w", seed=0, device="cuda")
    perturb_zero_params(pipe, seed=99)
    torch.cuda.synchronize()
    log(f"path: built zeroscope-v2-576w (seeded random init, zero leaves "
        f"perturbed) in {time.perf_counter() - t0:.1f} s; "
        f"params: {sum(p.numel() for p in pipe.parameters()) / 1e9:.3f} B")

    prompt_a = "a red panda rides a bicycle through a snowy forest"
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    video, (zs, epss, ts) = generate(pipe, prompt_a, seed=7, num_steps=steps_a,
                                     record=True)
    torch.cuda.synchronize()
    sec_a = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    root_a = MerkleCommitment(ts, zs, epss).root.hex()
    log(f"request A: video {tuple(video.shape)} {video.dtype}, {steps_a} steps, "
        f"{sec_a:.2f} s/request, peak memory {peak / 2**30:.2f} GiB, "
        f"merkle root {root_a} over {len(ts)} leaves")
    log(f"request A launches: {json.dumps(launches)}")
    if video.shape != (16, 320, 576, 3) or video.dtype != np.uint8:
        raise AssertionError(f"request A: bad video {video.shape} {video.dtype}")
    if not (torch.isfinite(zs.float()).all() and torch.isfinite(epss.float()).all()):
        raise AssertionError("request A: non-finite latents or eps")
    if len(ts) != steps_a or zs.shape[0] != steps_a:
        raise AssertionError("request A: wrong number of PoI leaves")
    if float(np.std(video)) == 0.0:
        raise AssertionError("request A: constant video")
    missing = [k for k in MODEL_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"request A never launched: {missing}")

    runs = []
    reset_counts()
    for rep in range(2):
        t0 = time.perf_counter()
        vid, (zb, eb, tb) = generate(pipe, "a lighthouse at dusk, waves crashing",
                                     negative_prompt="blurry", seed=123456789,
                                     num_steps=3, record=True)
        torch.cuda.synchronize()
        runs.append((vid, zb, eb, MerkleCommitment(tb, zb, eb).root.hex(),
                     time.perf_counter() - t0))
        if rep == 0:
            launches_b = read_counts()
    (v1, z1, e1, r1, s1), (v2, z2, e2, r2, s2) = runs
    same = (torch.equal(z1.view(torch.int16), z2.view(torch.int16))
            and torch.equal(e1.view(torch.int16), e2.view(torch.int16))
            and np.array_equal(v1, v2) and r1 == r2)
    log(f"request B: 3 steps twice ({s1:.2f} s, {s2:.2f} s), roots {r1} / {r2}, "
        f"bit-identical={same}")
    if not same:
        raise AssertionError("request B: re-execution is not bit-identical")
    # A and B share the text encoding and the 16-frame decode, so their
    # difference is (steps_a - 3) denoise steps (one batched UNet call each)
    extra = steps_a - 3
    per_step = {k: (launches[k] - launches_b[k]) / extra for k in launches}
    step_s = (sec_a - s2) / extra
    log(f"path: per denoise step {step_s:.4f} s, rest of a request (text, noise, "
        f"decode) {sec_a - steps_a * step_s:.3f} s; launches per UNet call "
        f"{json.dumps(per_step)}")
    wrong = {k: per_step[k] for k, n in EXPECTED_PER_UNET_CALL.items() if per_step[k] != n}
    if wrong:
        raise AssertionError(f"launches per UNet call {wrong}, expected "
                             f"{EXPECTED_PER_UNET_CALL}")
    reexec = check_reexecution(pipe, prompt_a, 7, video, zs, epss, ts, root_a)

    # the bound of one batched UNet call and of one frame's decode, summed
    # over the launches each makes at the default geometry
    hidden = encode_prompts(pipe, ["", "a red panda rides a bicycle"])
    z = rng.video_noise(rng.base_key(7), 16, (40, 72, 4), device="cuda")[None].bfloat16()
    t = int(make_ddim_schedule(steps_a).timesteps[0])
    unet_bounds = launch_bounds(pipe.unet, lambda: unet_pair_call(pipe.unet, z, hidden, t))

    def decode_one_frame():
        with torch.inference_mode():
            pipe.vae_decoder(z[0, :1].float())
    vae_bounds = launch_bounds(pipe.vae_decoder, decode_one_frame)
    log(f"path: bound per UNet call {json.dumps(unet_bounds)}")
    log(f"path: bound per frame's VAE decode {json.dumps(vae_bounds)}")
    return launches, dict(seconds_per_request=sec_a, steps=steps_a,
                          peak_bytes=peak, root=root_a,
                          seconds_request_b=[s1, s2], seconds_per_step=step_s,
                          launches_request_b=launches_b,
                          launches_per_unet_call=per_step, reexecution=reexec,
                          bound_per_unet_call=unet_bounds,
                          bound_per_vae_frame=vae_bounds)


def check_reexecution(pipe, prompt, seed, video, zs, epss, ts, root_hex):
    """The validator's side on the card: re-derive z_0 from the seed,
    re-execute 3 revealed steps of Request A (the last among them) through
    ``StepEngine`` under the same-program tolerances (atol 1e-4, rtol 2^-7,
    ``dvdx_tpu/network/validator.py:93-99``) and require them bit for bit,
    bind the video on two audit-derived frames, and refuse an eps leaf
    scaled by 1 + 2^-4."""
    from dvdx_tpu_torch.verify.spotcheck import (StepEngine, binding_frame_indices,
                                                 compare_arrays, verify_revealed_steps)

    engine = StepEngine(pipe)
    steps = len(ts)
    checks = [3, 12, steps - 1]
    leaves = {i: (int(ts[i]), zs[i, 0], epss[i, 0])
              for c in checks for i in (c, c + 1) if i < steps}
    tol = dict(atol=1e-4, rtol=2.0 ** -7)
    reset_counts()
    t0 = time.perf_counter()
    base_ok, _, base_bitwise = compare_arrays(
        engine.base_latent(seed, *video.shape[:3]), zs[0, 0], bitwise=True, **tol)
    results, _ = verify_revealed_steps(engine, prompt, "", leaves, checks, steps, 7.5,
                                       same_platform=True, **tol)
    frames = binding_frame_indices(b"audit-secret", bytes.fromhex(root_hex), len(video))
    bound, bind_err = engine.verify_video_binding(
        video, leaves[steps - 1], steps - 1, steps, 7.5, prompt, frame_indices=frames)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    tampered = dict(leaves)
    t12, z12, e12 = leaves[12]
    tampered[12] = (t12, z12, (e12.float() * (1 + 2.0 ** -4)).bfloat16())
    refused, _ = verify_revealed_steps(engine, prompt, "", tampered, [12], steps, 7.5,
                                       same_platform=True, **tol)
    summary = {"checks": checks, "platform": engine.platform_tag,
               "base_latent_bitwise": base_bitwise,
               "passed": {i: r.passed for i, r in results.items()},
               "bitwise": {i: r.bitwise for i, r in results.items()},
               "binding_frames": frames, "binding_ok": bound, "binding_err": bind_err,
               "tampered_refused": not refused[12].passed,
               "tampered_reason": refused[12].reason, "seconds": seconds,
               "launches": counts}
    log(f"re-execution: {engine.platform_tag}, steps {checks} passed "
        f"{summary['passed']} bitwise {summary['bitwise']}; base latent bitwise "
        f"{base_bitwise}; video binding on frames {frames}: {bound} (mean |err| "
        f"{bind_err:.4f}); eps leaf x (1 + 2^-4) refused: {summary['tampered_refused']} "
        f"({refused[12].reason}); {seconds:.2f} s for the verification; launches "
        f"{json.dumps(counts)}")
    if not (base_ok and base_bitwise and all(r.passed and r.bitwise for r in results.values())):
        raise AssertionError(f"re-execution is not bit-identical: {summary}")
    if not bound or not summary["tampered_refused"]:
        raise AssertionError(f"video binding or tamper check failed: {summary}")
    missing = [k for k in MODEL_PATH if counts[k] == 0]
    if missing:
        raise AssertionError(f"re-execution never launched: {missing}")
    return summary


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    import dvdx_tpu_torch
    from dvdx_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    dvdx_tpu_torch.enable_determinism()
    os.makedirs(OUT_DIR, exist_ok=True)

    t0 = time.perf_counter()
    build = _build.build_all()
    log(f"build: {len(build)} kernels in {time.perf_counter() - t0:.1f} s "
        + " ".join(f"{k}={v['seconds']:.1f}s" for k, v in build.items()))
    with open(os.path.join(OUT_DIR, "build_ptxas.txt"), "w") as f:
        for k, v in build.items():
            f.write(f"==== {k}\n{v['ptxas']}\n")
    # registers, spills and shared memory of the redesigned kernels
    for k, names in (("groupnorm", ("gn_fused",)), ("temporal_block", ("temporal_block_chain",)),
                     ("spatial_tail", ("spatial_tail_chain",)),
                     ("temporal_attention", ("temporal_attn_tma",))):
        lines = build[k]["ptxas"].splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and any(n in line for n in names):
                log(f"ptxas {k}: " + " | ".join(x.split("ptxas info    :")[-1].strip()
                                               for x in lines[i:i + 4]))

    summary, rows = check_kernels()
    with open(os.path.join(OUT_DIR, "kernel_checks.json"), "w") as f:
        json.dump({"device": smi, "rows": rows}, f, indent=1)

    t0 = time.perf_counter()
    check_against_cpu()
    log(f"reference check: {time.perf_counter() - t0:.1f} s")
    launches, path = run_path(steps_a=25)
    with open(os.path.join(OUT_DIR, "path.json"), "w") as f:
        json.dump({"device": smi, "launches": launches, **path}, f, indent=1)

    kernels = []
    for name, s in summary.items():
        src, replaces = KERNEL_META[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": "operations" if s["t_ops"] > s["t_bytes"]
                        else "bytes", "library_ms": s["library_ms"]})
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
