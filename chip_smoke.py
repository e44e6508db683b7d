#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``dvdx_tpu_torch``) on one GPU.

    python3 chip_smoke.py    # needs one CUDA card
    python3 chip_smoke.py --kernels NAME[,NAME...]   # phases 1-2 for those
        # kernels alone (names as in the kernels line): their rows, no
        # contract line; a quick timing of a kernel's change, e.g. a copy of
        # the parent's package beside a copy of this script, run in one call
    python3 chip_smoke.py --cogvideox-hf   # phase 1, phase 2 for the CogVideoX
        # block's three kernels, and phase 14

Phases, each printing on its own lines; any failure raises and exits nonzero:
  1. the card's name and power limit (nvidia-smi), torch / CUDA versions;
     determinism flags set; build of every CUDA kernel from
     ``dvdx_tpu_torch/csrc`` (nvcc, sm_90a);
  2. each kernel against its plain PyTorch version on the card, in bf16, at
     the main path's full-width shapes, and the float32 kernels at phase 6's
     and at phase 13's full-width shapes (the fused tail's and block's
     float32 forms at level 0 and at a ragged S / N; float32 flash at S =
     2880 and 720, frame-axis attention at levels 1-3 (and at the fused
     block's level-0 shape and XL's 24 frames), GEGLU's float32
     pair at C = 640 / 1280, GroupNorm at the UNet's and the VAE's shapes)
     (and a few off it: the fused tail at
     C = 384, with tiles spanning two images, at T = 300, at C = 64 with T =
     16, at head width 40 and at C = 640 (the wide chain); frame-axis
     attention at 24-128 frames with head widths 40 / 64 / 128 in both
     layouts; flash_attention_mh, GEGLU's two launches on their own at level
     2, GroupNorm with a level-0 pre-bias and with ragged chunks, the fused
     block at a ragged N and at F = 24; GEGLU's CUDA-core pair in bf16 at C
     = 40; flash and frame-axis attention in float32; float32 flash at S =
     777 with D = 40, at D = 128, on rows its tensor-core body cannot take,
     and at the tail's cross-attention shape on each body; float32 GEGLU at
     a ragged T and at C = 30), and the shapes the
     XL geometry adds (flash at 9216 tokens, held on two frames' batch-heads,
     and at level 2's 576; the fused tail and block over 24 x 9216; GroupNorm
     at the UNet's level 0 and the VAE's full 1024x576 frame), the
     frame-sharded GroupNorm's two entries (moments-out: the float32 moments
     of its float64 sums bit-equal to the plain version's; moments-in given
     the same moments) at the UNet's level-0 and level-2 frame-sharded
     norms, and the published CogVideoX block's three kernels at
     cogvideox-5b-hf's shapes (``qk_norm_rope`` over (2, 17,776, 48, 64),
     ``bias_gelu`` at C = 12,288, ``gated_residual`` at C = 3072; each
     output within one bf16 rounding step of the plain version's, at least
     99% the same bits), with kernel /
     plain / library times
     (CUDA events, the launches queued behind a device spin), the roofline
     bound (the fused kernels' also split into their chain and FF launches),
     and a second call that must give the same bits;
  3. the reference check: one UNet call of a small model of the same
     structure on the card (kernels) and on the CPU (plain versions) from
     the same weights and inputs, every kernel of the model path launched;
     the base noise's bits on the card and on the CPU;
  4. the main path: zeroscope-v2-576w with the JAX package's seeded weights
     for that registry name (``utils.init.fast_init``; zero-init leaves
     perturbed so every layer carries signal), their digest held to the
     JAX-derived constant first (phase 11(a)). Request A: 16 frames at
     576x320, 25 DDIM steps, CFG 7.5, PoI recording, Merkle root (held to
     the recorded ``REQUEST_A_ROOT``), committed through the native hasher
     (``utils.native``, the default) and through the plain hashlib loop,
     which must give the same leaves and root (both timed); every
     kernel of the model path must have launched, as often per UNet call as
     the layers' routing says. Request B: another prompt and seed, 3 steps,
     run twice; leaves and roots must be bit-identical. The validator's
     re-execution (``verify.spotcheck.StepEngine``) of 3 revealed steps of
     Request A must reproduce them bit for bit, bind the video, and refuse a
     tampered eps leaf. Then each kernel's bound summed over one UNet call
     and one frame's VAE decode, from the shapes its layers hand it; and one
     bf16 UNet call under ``utils.profiling.trace`` and
     ``span("unet_call")``, whose Chrome trace must hold the annotation
     and each model-path kernel's device events (at least its launches in
     the call), with ``device_memory()`` beside ``max_memory_allocated``;
  5. a network round at full width on the same pipeline
     (``network.mock.build_mock_network``): an honest, a lazy and a
     wrong-video miner generate 16 frames at 576x320, 25 steps, at once in
     three threads; the validator (3 re-executed steps) must pass the honest
     one bit for bit in the same-program regime, catch the lazy one at
     ``reexecution`` (its stake slashed) and the wrong-video one at
     ``video_binding``, and settle the request on the ledger; every kernel
     of the model path must launch during the round;
  6. a cross-device round: zeroscope-tiny (the rotary temporal style,
     float32) miners on the card, a validator on the CPU with the same
     weights; the honest miner must pass in the cross-platform regime (atol
     5e-2) and the lazy one be caught at ``reexecution``; GroupNorm's float32
     kernel and GEGLU's float32 pair must launch during the round;
  7. zeroscope-v2-xl from a synthetic diffusers checkpoint at zeroscope's
     full architecture (seeded random values, written under ``build/`` and
     deleted after loading), loaded by ``resolve_pipeline``: the XL PoI
     request (24 frames at 1024x576, 50 steps, CFG 7.5, cfg_split, segments
     of 10) through ``StepEngine.generate_recorded`` with the checkpoint's
     BPE tokenizer, launches per UNet call as the routing says (flash also
     at level 2), its record committed natively and through hashlib (the
     same leaves and root, both timed); every distinct input one cfg_split UNet call and one
     frame's decode hand a kernel, recorded where the layers call it and
     held against the plain version (2 bf16 ulps, the same bits on a second
     call), on those inputs and on random ones of the same shapes and
     strides; that UNet call and that decode run again through the plain
     versions, within ``REFERENCE_RELRMS_TOL`` of the kernels'; the CLI's
     segmented runner on the same inputs, whose video must be the same
     bits; 3 re-executed steps (bitwise); one frame decoded full and in
     tiles; ``python -m dvdx_tpu_torch generate`` run with no device flag,
     which must run on the card;
  8. the network as processes: one validator and three miners of
     zeroscope-v2-576w started as four ``python -m dvdx_tpu_torch`` processes
     with no device flag and ``DVDX_PARAM_CACHE`` set to the file phase 12
     wrote, so each loads its weights instead of drawing them (the file is
     deleted after the phase; each in its own directory under
     ``build/services/``; the validator scores VQ with LPIPS(alex) from a
     seeded lpips-package checkpoint written there). The three miners must
     register pinned ``torch-cuda``; a request goes through ``/deposit`` and
     ``/submit_prompt`` to ``completed`` (16 frames at 576x320, 25 steps, 3
     re-executed steps per miner); every miner must pass bit for bit in the
     same-program regime with an ``lpips-alex`` score above 0; a video is
     served by ``/videos`` and its LPIPS on the CPU matches the validator's;
     ``/weights`` holds the settled scores of ``validator_state.npz``; every
     kernel of the model path launched in each process; the card holds the
     services' memory (nvidia-smi); and this process's kernel path
     (``StepEngine.generate_recorded`` on the same prompt, seed and
     geometry) gives each miner's Merkle root. Start-up seconds, the round's
     wall seconds, each miner's ``timings_s`` and each process's device
     memory are printed;
  9. the other families at full width and depth, the JAX package's seeded
     weights:
     cogvideox-5b (the v-prediction video DiT, 7.17 B + a 3.83 B text tower,
     bf16): one recorded request through ``StepEngine`` at its native 48 x
     720x480 (latent 48 x 60 x 90 x 16; 65,026 joint tokens), 3 of its 50
     steps, every frame decoded, 2 revealed steps re-executed bit for bit
     with the video bound; one frame's decode as the request makes it, its
     GroupNorm inputs (60x90 to 480x720) held against the plain version;
     one batched DiT call traced (s/step, device ms, 42 flash launches);
     flash at (2, 65,026, 48, 64) held against its plain version on
     query-row slices (tile 0, the text / video boundary tile, the ragged
     last tiles), on the path's inputs and random ones, timed beside SDPA
     and its bound; one 4-frame DiT call through the plain versions, its
     flash inputs (S = 5,626) held on row slices; an in-process round at 16
     frames and 3 steps (honest bitwise, lazy caught), its flash inputs (S
     = 21,826) held on row slices and any kernel input the frame's decode
     did not give held against the plain version. svd-img2vid (the UNet
     taking 8 channels, a 1-token image context, 25 frames): a full request from a seeded
     576x320 image (25 steps, CFG 3.0, recorded) twice, bit for bit; every
     distinct kernel input of one batched UNet call and of one VAE encode
     held against the plain versions, and that call through them;
 14. the published CogVideoX-5B, ``cogvideox-5b-hf`` (5.57 B + the 4.76 B
     T5 encoder, bf16, weights drawn on the card; run after phase 9): a
     recorded request at its benchmark geometry (13 x 480x720: 226 text +
     17,550 video = 17,776 joint tokens, 2 steps, every frame decoded);
     one CFG step (one batch-2 DiT call) with the launch counters set to 0
     just before it, which must launch per block one ``qk_norm_rope``, one
     flash attention, one ``bias_gelu`` and two ``gated_residual``, and 132
     bias epilogues a call, and nothing else; that step's kernel inputs,
     recorded where the layers call them, held against the plain versions
     on those inputs and on random ones of the same shapes and strides:
     the block's three kernels within one bf16 rounding step of their plain
     versions with at least 99% of the outputs the same bits, the bias
     epilogue bit for bit (to_qkv over 2 x 17,776 rows of 9,216), flash at
     (2, 17,776, 48, 64) on query-row slices; the same bits on a second
     call; each kernel's ms beside its bound (``cogvideox_hf.json``);
 10. the distribution pillar (``dvdx_tpu_torch.parallel``) on Request A's
     model, prompt and seed (16 x 576x320, 25 steps, CFG 7.5): single,
     chunk, hybrid_ctx and precond through ``build_runner`` in this process
     (2 chunks of 9 frames: UNet calls at batch 4), single's video equal to
     Request A's, hybrid_ctx run twice bit for bit, s/video, peak memory and
     the boundary metrics (``scoring.temporal``) against single's video;
     fsdp, cp_exact and cp_ulysses (3 steps) on a one-rank NCCL group, each
     bit-equal to single, the fsdp all-gathers launched (at a seq axis of 1
     cp_* are the fsdp program, as in the JAX package); the exact-CP program
     itself at that one rank (3 steps inside ``ring_context``, algo ring and
     auto: the routed layers, the conv halo, the frame-sharded GroupNorm's
     entry, the fused tail / block / frame-axis kernels off) within
     ``REFERENCE_RELRMS_TOL`` of single's latent, beside the same program
     with the fused gates off and no route taken (its distance from single
     and from the routed program), and ``ring_attention`` /
     ``ulysses_attention`` on the card at its frame-axis input against the
     plain attention; a mesh miner (fsdp ``Miner`` on that group) that
     shards its pipeline in place, with its peak memory beside the
     runner's; every distinct
     kernel input of one chunked UNet call held against the plain versions
     (2 bf16 ulps, the same bits again) with its launches and bound per
     kernel; a round of three hybrid_ctx miners (``build_mock_network``:
     honest, lazy, and one committing num_chunks 0) behind the validator,
     the honest one re-executed bit for bit in the hybrid_ctx regime, the
     lazy one caught at ``reexecution``, the liar at ``chunk_plan``; and
     ``python -m dvdx_tpu_torch strategy`` (one CSV row, every column
     filled) and ``coordinator`` (two worker processes on the card over
     sockets) as subprocesses, the coordinator's latent and video bit for
     bit the in-process chunk program run one chunk per UNet batch (the
     workers' batch of 2), and its distance from the batch-4 chunk video
     printed;
 11. one model per registry name: (a) in phase 4, ``utils.init.tree_digest``
     of Request A's weights (1.8 B, bf16, read back from the card) must equal
     the digest the JAX package derives for zeroscope-v2-576w at seed 0,
     perturbed at seed 99 (``utils.init.REFERENCE_DIGESTS``), with the
     start-up seconds printed; (b) Request A and its re-executed steps run on
     those weights (phase 4); (c) the orbax directory the JAX package's
     ``save_params`` wrote (``tests/data/zeroscope_tiny_p99_orbax``) loaded
     through tensorstore must equal the port's own zeroscope-tiny bit for
     bit, and a validator and a miner process on ``--params-ckpt`` run a
     round to ``completed`` with the miner bitwise; where tensorstore does
     not import, the miner must refuse the flag with exit 2 naming it;
 12. the frame-sharded GroupNorm and the weight cache (run right after
     phase 4): (a) Request A's first frame-sharded GroupNorm input (the
     first ``GroupNorm.over_frames`` of its first UNet call) with its
     frames split in two halves in this process: moments-out of each half,
     the float64 sums added, moments-in of each half, concatenated (the
     launch counts set to 0 just before and read just after: both entries
     must launch and nothing else); the moments bit-equal to the plain
     version's of the whole tensor, the result within 2 bf16 ulps of the
     plain version given them, the same bits again; (b) ``DVDX_PARAM_CACHE``
     under ``build/param_cache``: zeroscope-v2-576w built twice (the miss
     draws and writes the 3.35 GB file, the hit loads it), the hit perturbed
     at 99 must hash to ``REFERENCE_DIGESTS``; (c) the same GroupNorm
     through the port's entry ``group_norm_act_sharded`` at two gloo ranks
     on the one card (NCCL refuses two ranks on one device): each rank
     launches each entry once, and the result is bit-equal to (a)'s or
     within its tolerance of the plain version; the cache file is deleted
     whatever fails after it is written;
 13. float32 zeroscope-v2-576w (run right before phase 7, on the checkpoint
     phase 7 loads, here with ``load_diffusers_checkpoint(dtype="float32")``:
     7.0 GB of float32 weights, no leaf cast to bf16): (a) Request A's
     prompt, seed and geometry (16 x 576x320, CFG 7.5), 3 DDIM steps, recorded
     through ``StepEngine.generate_recorded`` twice, the leaves (bf16, as in
     both packages) and the root the same bits; (b) launches per UNet call
     of the float32 kernels as the routing says (``F32_EXPECTED_PER_UNET_CALL``:
     the fused tail 5, the block 6) and no bf16 kernel; (c) every distinct
     input one CFG UNet call and one frame's decode hand a kernel, held
     against the plain version (1e-5 of max|plain|, 1e-4 for GroupNorm) on
     those inputs and on random ones, the same bits again, and the call
     again bit for bit; (d) that call and that decode through the plain
     versions, within ``F32_PLAIN_RELRMS_TOL`` relative RMS; (e) 2 revealed
     steps re-executed bit for bit, the video bound, a tampered eps leaf
     refused; (f) the load seconds, s per request and per step, peak memory,
     one traced step's device ms by group (``utils.profile_step``), each
     float32 kernel's ms over the call beside its bound (``KERNEL_PEAK``);
     flash and the tail's cross-attention on the float32 attention's
     64-row tensor-core body, the frame-axis attentions (22 standalone, two
     in each of the 6 fused blocks) on its short-sequence body;
  then a ``kernels`` JSON line (each kernel's ``launches`` from the path
  that runs it: Request A, phase 12(c)'s two ranks for the two sharded
  GroupNorm entries, phase 13's float32 request for the float32 kernels,
  or phase 14's request for the CogVideoX block's three
  (phase 6's round under ``launches_cross_device_round``, phase 13's UNet
  call and frame under ``float32_per_unet_call`` / ``float32_vae_frame``);
  0 for those phase 2 alone holds; ``launches_xl`` from phase 7's request;
  ``launches_services`` per phase-8 process;
  ``xl_per_unet_call`` / ``xl_vae_frame`` from phase 7's held inputs:
  distinct shapes, launches, kernel ms summed over the launches, largest
  error, and per UNet call the bound; phase 9's launches per family path
  and per DiT call, svd's and cogvideox's held inputs, and flash at the
  DiT's three sequence lengths; phase 10's launches per strategy run and in
  the chunked round, and the chunked UNet call's held inputs and bound),
  and the result line.

Imports nothing of JAX or of the JAX package. Detail too long for the end of
the output goes to ``chiprun_out/``.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense TF32 on the tensor cores (NVIDIA data sheet)
PEAK_F64_FLOPS = 34e12     # H100 SXM float64 outside the tensor cores (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
OUT_DIR = "chiprun_out"
REPO_DIR = os.path.dirname(os.path.abspath(__file__))  # the checkout this script is in


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


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def randn(shape, gen, scale=1.0, shift=0.0, dtype=torch.bfloat16):
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    return (x * scale + shift).to(dtype)


# (flops, bytes) of one launch: each input read once, each output written
# once, bf16 activations and weights
def flash_cost(b, s, h, d):
    return 4.0 * b * h * s * s * d, 4.0 * b * s * h * d * 2


def cross_cost(b, sq, sk, h, d):
    # attention of Sq queries over Sk keys: q and the output Sq rows, k and v Sk
    return 4.0 * b * h * sq * sk * d, 2.0 * b * h * d * (sq + sk) * 2


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


def gn_cost(n, l, c, bias, elem=2):
    # x read, y written and the (N, C) bias, of elem bytes each; gamma and
    # beta (f32)
    return 8.0 * n * l * c, 2.0 * n * l * c * elem + (n * c * elem if bias else 0) + 8 * c


def gn_moments_cost(n, l, c, groups, elem=2):
    # x read; the (2, N, G) float64 sums written; a float64 add and a fused
    # multiply-add (3 operations) an element
    return 3.0 * n * l * c, n * l * c * elem + 2 * n * groups * 8.0


def gn_apply_cost(n, l, c, groups, elem=2):
    # x read, y written, gamma / beta and the (2, N, G) float32 moments read
    return 4.0 * n * l * c, 2.0 * n * l * c * elem + 8 * c + 2 * n * groups * 4.0


def f32_cost(cost):
    # a bf16 (flops, bytes) with every operand in float32 instead
    return cost[0], cost[1] * 2


# --- phase 2: kernels against their plain versions --------------------------

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

    # then the XL geometry's (zeroscope-v2-xl with cfg_split: batch 1, 24
    # frames, latent 72x128): level 0 over 9216 tokens (24 x 5 batch-heads)
    # and level 2, which flash's S >= 512 gate takes only at XL (576 tokens,
    # 24 x 20); plain attention over all of level 0 would hold 40 GB of
    # logits, so it is held on two frames' batch-heads (PLAIN_SLICE)
    for label, (b, s, h, d) in (("level0", (32, 2880, 5, 64)),
                                ("level1", (32, 720, 10, 64)),
                                ("ragged_d40", (4, 777, 3, 40)),
                                ("xl_level0", (24, 9216, 5, 64)),
                                ("xl_level2", (24, 576, 20, 64))):
        def mk(gen, b=b, s=s, h=h, d=d):
            return [randn((b, s, h, d), gen) for _ in range(3)]
        main = label in ("level0", "level1")
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

    PLAIN_SLICE[("flash_attention", "xl_level0")] = (
        "frames 0 and 23 (10 of 120 batch-heads)",
        lambda xs: [x[[0, 23]] for x in xs], lambda out: out[[0, 23]])

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
            ("vae_out_320x576", (1, 184320, 128, "silu", False, 1e-6, 1.0, 3.0)),
            # XL (cfg_split): the UNet's level 0 over 24 frames of 72x128, the
            # VAE decoder's full 1024x576 frame
            ("xl_resnet_l0", (24, 9216, 320, "silu", True, 1e-5, 2.0, 0.5)),
            ("xl_temporal_l0", (1, 221184, 320, "none", False, 1e-6, 2.0, 0.5)),
            ("xl_vae_up_576x1024_c256", (1, 589824, 256, "silu", False, 1e-6, 1.0, 3.0)),
            ("xl_vae_out_576x1024", (1, 589824, 128, "silu", False, 1e-6, 1.0, 3.0))):
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
        cases.append(("group_norm_act", label, mk, kern, plain, lib, gn_cost(n, l, c, bias),
                      label not in GN_OFF_PATH and not label.startswith("xl_")))

    # the frame-sharded GroupNorm's two entries at the UNet's frame-sharded
    # norms (statistics over frames and positions): level 0's temporal
    # transformer norm (2 x 16 frames x 2880 positions, C = 320, eps 1e-6)
    # and level 2's temporal conv norm (180 positions, C = 1280, SiLU);
    # moments-out held by the float32 moments of its float64 sums, bit for
    # bit (COMPARE_AS), moments-in given the plain version's moments
    for label, (n, l, c, act) in (("temporal_l0", (2, 46080, 320, "none")),
                                  ("temporal_conv_l2", (2, 2880, 1280, "silu"))):
        def mk_out(gen, n=n, l=l, c=c):
            return [randn((n, l, c), gen, 2.0, 0.5)]

        def mk_in(gen, n=n, l=l, c=c):
            x = randn((n, l, c), gen, 2.0, 0.5)
            sums, count = gn._moment_sums(x.float(), 32)
            return [x, torch.rand((c,), generator=gen, device="cuda") + 0.5,
                    torch.randn((c,), generator=gen, device="cuda") * 0.1,
                    tuple((sums / count).float())]
        cases.append(("group_norm_moments_out", label, mk_out,
                      lambda x: gn.group_norm_moments(x, 32)[0],
                      lambda x: gn._moment_sums(x.float(), 32)[0], None,
                      gn_moments_cost(n, l, c, 32), True))
        cases.append(("group_norm_moments_in", label, mk_in,
                      lambda x, w, b_, m, act=act: gn.group_norm_apply(
                          x, w, b_, m, groups=32, eps=1e-6, act=act),
                      lambda x, w, b_, m, act=act: gn.group_norm_act_plain(
                          x, w, b_, groups=32, eps=1e-6, act=act, moments=m), None,
                      gn_apply_cost(n, l, c, 32), True))

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

    def linear_params(keys, shapes, gen, dtype=torch.bfloat16):
        # weights N(0, 1/fan_in), biases and LayerNorm biases N(0, 0.1^2),
        # LayerNorm scales 1 + N(0, 0.1^2)
        out = {}
        for key in keys:
            shape = shapes[key]
            if len(shape) == 2:
                out[key] = randn(shape, gen, shape[1] ** -0.5, dtype=dtype)
            else:
                out[key] = randn(shape, gen, 0.1, 1.0 if key.endswith("_s") else 0.0,
                                 dtype=dtype)
        return out

    # the main path's level 0, then off it: C = 384 (two ring stages), S =
    # 721 (tiles spanning two images), T = 300 (two sweeps over 128-token
    # fills), C = 64 with T = 16, head width 40, C = 640 (the wide chain),
    # and XL's level 0 (24 x 9216 rows)
    for label, (n, s_, c, heads, t), main in (("level0", (32, 2880, 320, 5, 77), True),
                                              ("c384", (8, 2880, 384, 6, 77), False),
                                              ("s721_spanning", (32, 721, 320, 5, 77), False),
                                              ("t300_two_sweeps", (8, 2880, 320, 5, 300), False),
                                              ("c64_t16", (8, 1024, 64, 1, 16), False),
                                              ("d40", (8, 2880, 320, 8, 77), False),
                                              ("c640", (32, 720, 640, 10, 77), False),
                                              ("xl_level0", (24, 9216, 320, 5, 77), False)):
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
    # tile, keys padded to 32) with both head layouts, at a ragged N and at
    # XL's 9216 positions
    for label, (b, f, n, heads) in (("level0", (2, 16, 2880, 5)),
                                    ("transformer_in_d40", (2, 16, 2880, 8)),
                                    ("f16_ragged_n", (2, 16, 2881, 5)),
                                    ("f24_5x64", (2, 24, 2881, 5)),
                                    ("f24_8x40", (2, 24, 2881, 8)),
                                    ("xl_level0", (1, 24, 9216, 5)),
                                    ("xl_transformer_in_d40", (1, 24, 9216, 8))):
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

    # float32: phase 6's zeroscope-tiny path at 4
    # frames of 32x32 (latent 16x16, CFG batch 2) hands GroupNorm and GEGLU
    # these shapes; GEGLU also in bf16 at a width the wgmma pair does not
    # take, flash at zeroscope-tiny's level 0 for 64x64 frames and
    # frame-axis attention at zeroscope-tiny-hf's level 0, both off the paths
    f32 = torch.float32
    for label, (n, l, c, act, bias, eps, groups) in (
            ("tiny_resnet_l0", (8, 256, 32, "silu", True, 1e-5, 8)),
            ("tiny_temp_conv_l0", (2, 1024, 32, "silu", False, 1e-5, 8)),
            ("tiny_resnet_l1", (8, 64, 64, "silu", True, 1e-5, 8)),
            ("tiny_vae_32x32", (1, 1024, 32, "silu", False, 1e-6, 4))):
        def mk(gen, n=n, l=l, c=c, bias=bias):
            xs = [randn((n, l, c), gen, 2.0, 0.5, f32),
                  torch.rand((c,), generator=gen, device="cuda") + 0.5,
                  torch.randn((c,), generator=gen, device="cuda") * 0.1]
            xs.append(randn((n, c), gen, dtype=f32) if bias else None)
            return xs

        def kern(x, w, b_, bias, act=act, eps=eps, g=groups):
            return gn.group_norm_act(x, w, b_, groups=g, eps=eps, act=act, bias=bias)

        def plain(x, w, b_, bias, act=act, eps=eps, g=groups):
            return gn.group_norm_act_plain(x, w, b_, groups=g, eps=eps, act=act, bias=bias)

        def lib(x, w, b_, bias, act=act, eps=eps, g=groups):
            xb = x if bias is None else x + bias[:, None, :]
            y = F.group_norm(xb.transpose(1, 2), g, w, b_, eps)
            return F.silu(y) if act == "silu" else y
        cases.append(("group_norm_act_f32", label, mk, kern, plain, lib,
                      gn_cost(n, l, c, bias, 4), True))

    for label, (t, c, dtype, main) in (("tiny_l0", (2048, 32, f32, True)),
                                       ("tiny_l1", (512, 64, f32, True)),
                                       ("bf16_c40", (300, 40, torch.bfloat16, False))):
        inner = 4 * c

        def mk(gen, t=t, c=c, inner=inner, dtype=dtype):
            return [randn((t, c), gen, dtype=dtype),
                    randn((2 * inner, c), gen, c ** -0.5, dtype=dtype),
                    randn((2 * inner,), gen, 0.1, dtype=dtype),
                    randn((c, inner), gen, inner ** -0.5, dtype=dtype),
                    randn((c,), gen, 0.1, dtype=dtype)]
        cost = geglu_cost(t, c, inner)
        cases.append(("geglu_ff_simt", label, mk, gf.geglu_ff, gf.geglu_ff_plain, None,
                      f32_cost(cost) if dtype == f32 else cost, main))

    def mk_flash(gen):
        return [randn((2, 1024, 2, 16), gen, dtype=f32) for _ in range(3)]
    cases.append(("flash_attention_f32", "tiny_64x64_level0", mk_flash, fa.flash_attention,
                  fa.flash_attention_plain, sdpa_bshd, f32_cost(flash_cost(2, 1024, 2, 16)),
                  False))
    for label, shape, kern, plain, lib in (
            ("tiny_hf_level0", (2, 4, 256, 32),
             lambda q, k, v: ta.temporal_attention(q, k, v, heads=2),
             lambda q, k, v: ta.temporal_attention_plain(q, k, v, heads=2), sdpa_fm(2)),
            ("tiny_hf_level0_posmajor", (2, 256, 4, 32),
             lambda q, k, v: ta.temporal_attention_posmajor(q, k, v, heads=2),
             lambda q, k, v: ta.temporal_attention_plain(
                 q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 heads=2).transpose(1, 2),
             lambda q, k, v: sdpa_fm(2)(q.transpose(1, 2), k.transpose(1, 2),
                                        v.transpose(1, 2)))):
        def mk(gen, shape=shape):
            return [randn(shape, gen, dtype=f32) for _ in range(3)]
        cases.append(("temporal_attention_f32", label, mk, kern, plain, lib,
                      f32_cost(temporal_cost(2, 4, 256, 2, 16)), False))

    # float32 zeroscope-v2-576w (phase 13) at 16 x 576x320: the fused tail and
    # block at level 0 (and each at a ragged shape: S = 721, N = 2881), and
    # the other float32 kernels at the shapes the layers hand them there
    for label, (n, s_, c, heads, t), main in (("level0", (32, 2880, 320, 5, 77), True),
                                              ("s721_ragged", (3, 721, 320, 5, 77), False)):
        shapes = {k: (c,) for k in st.KEYS}
        shapes.update({"o1_w": (c, c), "q2_w": (c, c), "o2_w": (c, c),
                       "ffi_w": (8 * c, c), "ffi_b": (8 * c,), "ffo_w": (c, 4 * c)})

        def mk(gen, n=n, s_=s_, c=c, t=t, shapes=shapes):
            return [randn((n, s_, c), gen, dtype=f32), randn((n, s_, c), gen, dtype=f32),
                    randn((n, t, c), gen, dtype=f32), randn((n, t, c), gen, dtype=f32),
                    linear_params(st.KEYS, shapes, gen, f32)]
        cases.append(("fused_spatial_tail_f32", label, mk,
                      lambda *a, h=heads: st.fused_spatial_tail(*a, heads=h),
                      lambda *a, h=heads: st.fused_spatial_tail_plain(*a, heads=h), None,
                      f32_cost(spatial_tail_cost(n * s_, c, c, c, t, n)), main))
    for label, (b, f, n, heads), main in (("level0", (2, 16, 2880, 5), True),
                                          ("transformer_in_d40", (2, 16, 2880, 8), True),
                                          ("n2881_ragged", (2, 16, 2881, 5), False)):
        c = 320
        shapes = {k: (c,) for k in tb.KEYS}
        shapes.update({k: (c, c) for k in ("q1", "k1", "v1", "o1_w", "q2", "k2", "v2", "o2_w")})
        shapes.update({"ffi_w": (8 * c, c), "ffi_b": (8 * c,), "ffo_w": (c, 4 * c)})

        def mk(gen, b=b, f=f, n=n, c=c, shapes=shapes):
            return [randn((b, f, n, c), gen, dtype=f32), linear_params(tb.KEYS, shapes, gen, f32)]
        cases.append(("fused_temporal_block_f32", label, mk,
                      lambda x, p, h=heads: tb.fused_temporal_block(x, p, heads=h),
                      lambda x, p, h=heads: tb.fused_temporal_block_plain(x, p, heads=h), None,
                      f32_cost(temporal_block_cost(b * f * n, f, c)), main))
    for label, (b, s_, h, d) in (("level0", (32, 2880, 5, 64)), ("level1", (32, 720, 10, 64))):
        def mk(gen, b=b, s_=s_, h=h, d=d):
            return [randn((b, s_, h, d), gen, dtype=f32) for _ in range(3)]
        cases.append(("flash_attention_f32", label, mk, fa.flash_attention,
                      fa.flash_attention_plain, sdpa_bshd, f32_cost(flash_cost(b, s_, h, d)),
                      True))
    # the float32 attention's two bodies off the flash path: a ragged S at D =
    # 40 and D = 128 (tensor cores), and 66-float rows, which its 16-byte
    # copies cannot take (the CUDA-core rows); the fused tail's
    # cross-attention shape (2880 queries, 77 keys) on each body, the rows
    # reached through 66-float context rows
    from dvdx_tpu_torch.ops.kernels import attention_f32 as af

    def sdpa_packed(q, k, v):  # SDPA's kernels refuse rows that are not 16-byte aligned
        return sdpa_bshd(q.contiguous(), k.contiguous(), v.contiguous())

    def att_f32(q, k, v):
        b, s_, h, d = q.shape
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        af.launch(q, k, v, out, batch=b, n=1, heads=h, s_q=s_, s_k=k.shape[1], d=d,
                  strides=fa.f32_strides(q, k, v, out), scale=d ** -0.5, what="phase 2")
        return out
    for label, (b, s_, sk, h, d, pad), kern in (
            ("s777_d40", (2, 777, 777, 3, 40, 0), fa.flash_attention),
            ("s130_d128", (1, 130, 130, 3, 128, 0), fa.flash_attention),
            ("s600_rows66_cuda_cores", (2, 600, 600, 2, 64, 2), fa.flash_attention),
            ("tail_cross_tensor_cores", (32, 2880, 77, 5, 64, 0), att_f32),
            ("tail_cross_cuda_cores", (32, 2880, 77, 5, 64, 2), att_f32)):
        def mk(gen, b=b, s_=s_, sk=sk, h=h, d=d, pad=pad):
            q = randn((b, s_, h, d + pad), gen, dtype=f32)[..., :d]
            return [q] + [randn((b, sk, h, d + pad), gen, dtype=f32)[..., :d] for _ in range(2)]
        cases.append(("flash_attention_f32", label, mk, kern, fa.flash_attention_plain,
                      sdpa_packed if pad else sdpa_bshd, f32_cost(cross_cost(b, s_, sk, h, d)),
                      False))
    # frame-axis attention at levels 1-3 (the short-sequence body), then off
    # the standalone path: the fused block's level-0 shape (its two
    # attentions run this body inside the block) and XL's 24 frames at level 1
    for label, (b, f, n, heads, d), main in (("level1", (2, 16, 720, 10, 64), True),
                                             ("level2", (2, 16, 180, 20, 64), True),
                                             ("level3", (2, 16, 45, 20, 64), True),
                                             ("block_level0", (2, 16, 2880, 5, 64), False),
                                             ("xl_level1_f24", (1, 24, 2304, 10, 64), False)):
        def mk(gen, shape=(b, f, n, heads * d)):
            return [randn(shape, gen, dtype=f32) for _ in range(3)]
        cases.append(("temporal_attention_f32", label, mk,
                      lambda q, k, v, h=heads: ta.temporal_attention(q, k, v, heads=h),
                      lambda q, k, v, h=heads: ta.temporal_attention_plain(q, k, v, heads=h),
                      sdpa_fm(heads), f32_cost(temporal_cost(b, f, n, heads, d)), main))
    # the fused block's two level-0 shapes on the CUDA-core rows, which take
    # positions 2 floats apart beyond their H*D (no 16-byte rows): what its
    # attentions cost on the rows, the same bytes read
    for label, (b, f, n, heads, d) in (("block_level0_rows", (2, 16, 2880, 5, 64)),
                                       ("block_transformer_in_rows", (2, 16, 2880, 8, 40))):
        def mk(gen, b=b, f=f, n=n, hd=heads * d):
            return [randn((b, f, n, hd + 2), gen, dtype=f32)[..., :hd] for _ in range(3)]
        cases.append(("temporal_attention_f32", label, mk,
                      lambda q, k, v, h=heads: ta.temporal_attention(q, k, v, heads=h),
                      lambda q, k, v, h=heads: ta.temporal_attention_plain(q, k, v, heads=h),
                      None, f32_cost(temporal_cost(b, f, n, heads, d)), False))
    for label, (t, c), main in (("level1", (23040, 640), True), ("level2", (5760, 1280), True),
                                ("level3", (1440, 1280), True),
                                ("t1001_c640", (1001, 640), False),
                                ("t33_c30_unaligned", (33, 30), False)):
        inner = 4 * c

        def mk(gen, t=t, c=c, inner=inner):
            return [randn((t, c), gen, dtype=f32),
                    randn((2 * inner, c), gen, c ** -0.5, dtype=f32),
                    randn((2 * inner,), gen, 0.1, dtype=f32),
                    randn((c, inner), gen, inner ** -0.5, dtype=f32),
                    randn((c,), gen, 0.1, dtype=f32)]
        cases.append(("geglu_ff_simt", label, mk, gf.geglu_ff, gf.geglu_ff_plain, None,
                      f32_cost(geglu_cost(t, c, inner)), main))
    for label, (n, l, c, act, bias, eps, scale, shift) in (
            ("resnet_l0", (32, 2880, 320, "silu", True, 1e-5, 2.0, 0.5)),
            ("temporal_l0", (2, 46080, 320, "none", False, 1e-6, 2.0, 0.5)),
            ("resnet_l2", (32, 180, 1280, "silu", True, 1e-5, 2.0, 0.5)),
            ("resnet_l3_concat", (32, 45, 2560, "silu", False, 1e-5, 2.0, 0.5)),
            ("vae_mid", (1, 2880, 512, "silu", False, 1e-6, 1.0, 3.0)),
            ("vae_out_320x576", (1, 184320, 128, "silu", False, 1e-6, 1.0, 3.0))):
        def mk(gen, n=n, l=l, c=c, bias=bias, scale=scale, shift=shift):
            xs = [randn((n, l, c), gen, scale, shift, f32),
                  torch.rand((c,), generator=gen, device="cuda") + 0.5,
                  torch.randn((c,), generator=gen, device="cuda") * 0.1]
            xs.append(randn((n, c), gen, dtype=f32) if bias else None)
            return xs

        def kern(x, w, b_, bias, act=act, eps=eps):
            return gn.group_norm_act(x, w, b_, groups=32, eps=eps, act=act, bias=bias)

        def plain(x, w, b_, bias, act=act, eps=eps):
            return gn.group_norm_act_plain(x, w, b_, groups=32, eps=eps, act=act, bias=bias)

        def lib(x, w, b_, bias, act=act, eps=eps):
            xb = x if bias is None else x + bias[:, None, :]
            y = F.group_norm(xb.transpose(1, 2), 32, w, b_, eps)
            return F.silu(y) if act == "silu" else y
        cases.append(("group_norm_act_f32", f"full_{label}", mk, kern, plain, lib,
                      gn_cost(n, l, c, bias, 4), True))
    return cases


GN_OFF_PATH = ("temporal_l0_bias", "ragged_chunks")
# (kernel, shape label) -> the bound of each launch group of a fused kernel
BOUND_PARTS = {}
# (kernel, shape label) -> (description, inputs -> inputs of the slice, output
# -> the slice's output): cases whose plain version is held on a slice
PLAIN_SLICE = {}
# kernel -> (description, (output, inputs) -> what is held): kernels held by
# a function of their output, the same function of the plain version's
COMPARE_AS = {"group_norm_moments_out": (
    "the float32 (mean, E[x^2]) of the float64 sums",
    lambda sums, xs: (sums / (xs[0].shape[1] * xs[0].shape[2] // sums.shape[2])).float())}


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
    # the float32 forms (float32 models), and GEGLU's other pairs (float32, and
    # bf16 at widths the wgmma pair does not take)
    "group_norm_act_f32": ("dvdx_tpu_torch/csrc/groupnorm.cu",
                           "dvdx_tpu/ops/groupnorm.py:179"),
    "geglu_ff_simt": ("dvdx_tpu_torch/csrc/geglu_ff.cu",
                      "dvdx_tpu/ops/pallas/geglu_ff.py:98"),
    "flash_attention_f32": ("dvdx_tpu_torch/csrc/attention_f32.cu",
                            "dvdx_tpu/ops/pallas/flash_attention.py:470"),
    "temporal_attention_f32": ("dvdx_tpu_torch/csrc/attention_f32.cu",
                               "dvdx_tpu/ops/pallas/temporal_attention.py:183"),
    "fused_spatial_tail_f32": ("dvdx_tpu_torch/csrc/spatial_tail_f32.cu",
                               "dvdx_tpu/ops/pallas/spatial_tail.py:304"),
    "fused_temporal_block_f32": ("dvdx_tpu_torch/csrc/temporal_block_f32.cu",
                                 "dvdx_tpu/ops/pallas/temporal_block.py:146"),
    # frame-sharded GroupNorm: the kernel's first and last phases as two
    # entries, an all-reduce between them (the JAX package: group_norm_act
    # under GSPMD's implicit all-reduce)
    "group_norm_moments_out": ("dvdx_tpu_torch/csrc/groupnorm.cu",
                               "dvdx_tpu/ops/groupnorm.py:179"),
    "group_norm_moments_in": ("dvdx_tpu_torch/csrc/groupnorm.cu",
                              "dvdx_tpu/ops/groupnorm.py:179"),
    # the bias (+ residual) epilogue of the convolutions and dense layers,
    # bf16 and float32: no TPU kernel (XLA fuses the bias add into the product)
    "bias_epilogue": ("dvdx_tpu_torch/csrc/bias_epilogue.cu", None),
    "bias_epilogue_f32": ("dvdx_tpu_torch/csrc/bias_epilogue.cu", None),
    # the published CogVideoX block's QK-LayerNorm and rotation, and its
    # feed-forward / gated-residual epilogues: no TPU kernel (the JAX
    # package has no such block)
    "qk_norm_rope": ("dvdx_tpu_torch/csrc/qk_norm_rope.cu", None),
    "bias_gelu": ("dvdx_tpu_torch/csrc/dit_epilogue.cu", None),
    "gated_residual": ("dvdx_tpu_torch/csrc/dit_epilogue.cu", None),
}
# the two entries phase 12's two-half split runs
SHARDED_GN_PATH = ("group_norm_moments_out", "group_norm_moments_in")
# the float32 form of each model-path kernel, by the name the layers call
F32_NAME = {"flash_attention": "flash_attention_f32",
            "temporal_attention": "temporal_attention_f32", "geglu_ff": "geglu_ff_simt",
            "group_norm_act": "group_norm_act_f32", "fused_spatial_tail": "fused_spatial_tail_f32",
            "fused_temporal_block": "fused_temporal_block_f32"}
# the float32 forms, which phase 13's model runs
F32_KERNELS = tuple(F32_NAME.values())
# the float32 forms whose products run float32-accurate on the tensor cores
# in three TF32 passes (csrc/tf32_mma.cuh): their bound takes a third of the
# TF32 peak; the others run f32 operations on the CUDA cores
TF32_KERNELS = ("flash_attention_f32", "geglu_ff_simt", "fused_spatial_tail_f32",
                "fused_temporal_block_f32")
# the peak rate each kernel's operations run at, where it is not the bf16
# tensor cores'
KERNEL_PEAK = {**{k: PEAK_F32_FLOPS for k in F32_KERNELS},
               **{k: PEAK_TF32_FLOPS / 3 for k in TF32_KERNELS},
               "group_norm_moments_out": PEAK_F64_FLOPS,
               "group_norm_moments_in": PEAK_F32_FLOPS}


def kernel_peak(name: str, dtype) -> float:
    """The peak rate of kernel ``name``'s operations on ``dtype`` inputs:
    GEGLU's other pair takes bf16 at odd widths on the CUDA cores."""
    if name == "geglu_ff_simt" and dtype == torch.bfloat16:
        return PEAK_F32_FLOPS
    return KERNEL_PEAK.get(name, PEAK_BF16_FLOPS)
# the kernels the UNet / VAE path runs (flash_attention_mh is opt-in in the
# JAX package and off the port's path: phase 2 alone holds it)
MODEL_PATH = ("flash_attention", "temporal_attention", "geglu_ff", "group_norm_act",
              "fused_spatial_tail", "fused_temporal_block")
# the kernels phase 6's float32 zeroscope-tiny miners run on the card
CROSS_DEVICE_PATH = ("group_norm_act_f32", "geglu_ff_simt")
# launches per batched UNet call of zeroscope-v2-576w at 16 x 576x320: flash
# in the 10 spatial transformers of levels 0-1 (S >= 512), the fused tail in
# the 5 of level 0, the fused block in transformer_in and the 5 level-0
# temporal transformers, frame-axis attention twice in each of the 11 other
# temporal transformers, GEGLU in the 11 other spatial and 11 other temporal
# transformers, GroupNorm in every resnet, temporal conv and transformer
EXPECTED_PER_UNET_CALL = {"flash_attention": 10, "temporal_attention": 22,
                          "geglu_ff": 22, "group_norm_act": 166,
                          "fused_spatial_tail": 5, "fused_temporal_block": 6}
# bias_epilogue launches per UNet call, at 576x320 and at XL alike: 166 of a
# layer's bias alone and 121 with the residual add that follows the layer
# (every resnet's conv2, temporal conv's last conv, transformer's proj_out
# and unfused attention's to_out), all but conv_out_zero's (C = 4);
# tests/test_torch_bias_epilogue.py counts them on the meta device
EPILOGUE_PER_UNET_CALL = 287
# max |kernel - plain| <= TOL_ULPS bf16 ulps (2^-7 relative) of max |plain|:
# both round to bf16 at the same points but sum in different orders, and the
# flash kernel rounds unnormalised probabilities (the plain version rounds
# normalised ones)
TOL_ULPS = 2.0
# float32 outputs: max |kernel - plain| <= this share of max |plain| (both in
# f32, summed in other orders; GroupNorm's one-pass variance cancels most
# of its sums)
F32_REL_TOL = {"group_norm_act_f32": 1e-4, "group_norm_moments_out": 0.0}
F32_REL_TOL_DEFAULT = 1e-5


def _add_sum(sums, row, t_ops, t_bytes):
    """Add a phase-2 row to its kernel's sums over its main-path (or its
    other) shapes."""
    s = sums.setdefault((row["kernel"], row["main_path"]),
                        dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                             library_ms=0.0, t_ops=0.0, t_bytes=0.0))
    s["max_abs_err"] = max(s["max_abs_err"], row["max_abs_err"])
    s["ms"] += row["ms"]
    s["plain_ms"] += row["plain_ms"]
    s["bound_ms"] += row["bound_ms"]
    s["t_ops"] += t_ops
    s["t_bytes"] += t_bytes
    s["library_ms"] = None if row["library_ms"] is None or s["library_ms"] is None \
        else s["library_ms"] + row["library_ms"]


# (label, rows, C) of the biased layer outputs on the main path: the UNet at
# 576x320 (CFG batch 2 x 16 frames) and XL (batch 1 x 24 frames), levels 0-3,
# and one 576x320 frame's VAE decode at its three widths (320x576, 160x288
# and 80x144 pixels)
EPILOGUE_SHAPES = (("level0", 92160, 320), ("level1", 23040, 640), ("level2", 5760, 1280),
                   ("level3", 1440, 1280), ("xl_level0", 221184, 320),
                   ("xl_level1", 55296, 640), ("xl_level2", 13824, 1280),
                   ("xl_level3", 3456, 1280), ("vae_c128", 184320, 128),
                   ("vae_c256", 46080, 256), ("vae_c512", 11520, 512))
EPILOGUE_KERNELS = ("bias_epilogue", "bias_epilogue_f32")


def epilogue_cost(rows, c, residual, elem=2):
    # one add an element (two with the residual); y read and written, the
    # residual read, the bias read
    return rows * c * (2.0 if residual else 1.0), (rows * c * (3 if residual else 2) + c) * elem


def epilogue_host_us(trials: int = 7, calls: int = 200) -> dict:
    """Host microseconds a call (best of ``trials`` runs of ``calls`` calls,
    the card idle before each run) of the epilogue through its wrapper and of
    the ATen adds it replaces, at the time embedding's (2, 1280) bf16 rows,
    where the card keeps up with the host."""
    from dvdx_tpu_torch.ops.kernels.bias_epilogue import bias_epilogue

    gen = torch.Generator(device="cuda").manual_seed(7)
    y, r = randn((2, 1280), gen), randn((2, 1280), gen)
    b = randn((1280,), gen)
    fns = {"wrapper_bias": lambda: bias_epilogue(y, b),
           "aten_bias": lambda: y + b,
           "wrapper_bias_residual": lambda: bias_epilogue(y, b, r),
           "aten_bias_residual": lambda: r + (y + b)}
    best = {k: float("inf") for k in fns}
    for _ in range(trials):
        for k, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            best[k] = min(best[k], (time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return best


def check_bias_epilogue():
    """The bias epilogue at each main-path shape, bf16 and float32, with and
    without the residual: in place, bit for bit ATen's pair (y + b and r +
    (y + b), which is also its plain version), the same bits again; timed in
    place on a copy, beside ATen's pair as the library and its bytes bound.
    Yields (row, t_ops, t_bytes). Then the host cost of a call against
    ATen's adds (``epilogue_host_us``)."""
    from dvdx_tpu_torch.ops.kernels import bias_epilogue as be

    gen = torch.Generator(device="cuda").manual_seed(4321)
    for dtype, name in ((torch.bfloat16, "bias_epilogue"), (torch.float32, "bias_epilogue_f32")):
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        elem = dtype.itemsize
        for label, n, c in EPILOGUE_SHAPES:
            for residual in (False, True):
                y = randn((n, c), gen, 3.0, dtype=dtype)
                b = randn((c,), gen, dtype=dtype)
                r = randn((n, c), gen, dtype=dtype) if residual else None
                ref = y + b if r is None else r + (y + b)
                out = y.clone()
                got = be.bias_epilogue(out, b, r)
                again = be.bias_epilogue(y.clone(), b, r)
                torch.cuda.synchronize()
                in_place = got.data_ptr() == out.data_ptr()
                exact = torch.equal(got.view(bits), ref.view(bits))
                repeat = torch.equal(again.view(bits), got.view(bits))
                err = (got.float() - ref.float()).abs().max().item()
                ms = cuda_ms(lambda: be.bias_epilogue(out, b, r), 20)
                lib_ms = cuda_ms(lambda: y + b if r is None else r + (y + b), 20)
                flops, nbytes = epilogue_cost(n, c, residual, elem)
                bms, bby = bound_ms(flops, nbytes, PEAK_F32_FLOPS)
                shape = label + ("_residual" if residual else "")
                ok = in_place and exact and repeat
                row = dict(kernel=name, shape=shape, max_abs_err=err, tol=0.0,
                           max_abs_ref=ref.float().abs().max().item(), repeat_bitwise=repeat,
                           ms=ms, plain_ms=lib_ms, library_ms=lib_ms, bound_ms=bms,
                           bound_by=bby, main_path=True, ok=ok, bound_ms_parts=None,
                           plain_on=None, held_as="bits (torch.equal), in place")
                log(f"kernel {name:20s} {shape:28s} bitwise={exact} in_place={in_place} "
                    f"ms={ms:.4f} library_ms={lib_ms:.4f} bound_ms={bms:.4f} ({bby}, "
                    f"{100 * bms / ms:.1f}% of it) repeat_bitwise={repeat} "
                    f"{'OK' if ok else 'FAIL'}")
                del y, b, r, ref, out, got, again
                torch.cuda.empty_cache()
                if not ok:
                    raise AssertionError(f"{name} {shape}: not ATen's pair bit for bit "
                                         f"({err:.3e}), not in place ({in_place}) or not "
                                         f"the same bits again ({repeat})")
                yield row, flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    host = epilogue_host_us()
    log("bias_epilogue host us a call (best of 7 x 200, (2, 1280) bf16): "
        + json.dumps({k: round(v, 3) for k, v in host.items()}))
    with open(os.path.join(OUT_DIR, "bias_epilogue_host_us.json"), "w") as f:
        json.dump(host, f, indent=1)


COG_HF_MODEL = "cogvideox-5b-hf"
# the geometry of a cogvideox-5b-hf request (portbench's configuration):
# 13 latent frames of 60 x 90, 226 text + 13 * 30 * 45 = 17,776 joint tokens
COG_HF = dict(num_frames=13, height=480, width=720, guidance_scale=6.0)
COG_HF_TOKENS = 226 + 13 * 30 * 45
COG_HF_STEPS = 2       # the recorded request's steps (of the family's 50)
# kernel launches per DiT call (both guidance rows in one batch-2 call): a
# qk_norm_rope, a flash attention, a bias_gelu and two gated_residual a
# block; the bias epilogue on every other Dense, 3 a block (norm1's and
# norm2's modulation, to_qkv) and 6 around them (the time embedding's two
# layers, patch_embed, text_proj, norm_out's modulation, proj_out)
COG_HF_PER_DIT_CALL = {"qk_norm_rope": 42, "bias_gelu": 42, "gated_residual": 84,
                       "flash_attention": 42, "bias_epilogue": 3 * 42 + 6}
# the block's own kernels, which only phase 14's model runs
COG_HF_PATH = ("qk_norm_rope", "bias_gelu", "gated_residual")
# kernel and plain version both compute in float32 and round once to bf16,
# in another order: each output within one bf16 rounding step of the plain
# value (2^-7 of it; near zero 2^-7 of 2^-8 of the largest output), and at
# least this share of the outputs the same bits
COG_HF_SAME_BITS = 0.99


def cog_hf_kernel_sites():
    """{kernel: (module whose global name the CogVideoX block calls, that
    name, plain version)} for the block's three kernels (``bias_gelu`` and
    ``gated_residual`` write into their first argument, ``IN_PLACE``)."""
    from dvdx_tpu_torch.models import cogvideox
    from dvdx_tpu_torch.ops.kernels import dit_epilogue as de
    from dvdx_tpu_torch.ops.kernels import qk_norm_rope as qk

    def qk_plain(q, k, norm_q, norm_k, cos, sin, n_text):
        return tuple(qk.qk_norm_rope_plain(x, n.weight, n.bias, n.eps, cos, sin, n_text)
                     for x, n in ((q, norm_q), (k, norm_k)))

    return {"qk_norm_rope": (cogvideox, "qk_norm_rope", qk_plain),
            "bias_gelu": (cogvideox, "bias_gelu_", de.bias_gelu_plain),
            "gated_residual": (cogvideox, "gated_residual_", de.gated_residual_plain)}


def cog_hf_cost(name, args):
    """(flops, bytes) of one launch of a CogVideoX block kernel on ``args``:
    each input read once and each output written once in bf16 (the rotary
    tables in float32); the float32 arithmetic about 10 operations a value
    for the norm and rotation and for the tanh-GELU, 3 for the gated add."""
    if name == "qk_norm_rope":
        q, cos = args[0], args[4]
        values = 2 * q.numel()
        return 10.0 * values, values * 2 * 2 + 2 * cos.numel() * 4
    y = args[0] if name == "bias_gelu" else args[1]
    c = y.shape[-1]
    if name == "bias_gelu":
        return 10.0 * y.numel(), (2 * y.numel() + c) * 2
    return 3.0 * y.numel(), (3 * y.numel() + c + 2 * y.shape[0] * c) * 2


def _one_rounding(got: torch.Tensor, want: torch.Tensor) -> dict:
    """``COG_HF_SAME_BITS``' criterion of one output against the plain
    version's."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = 2.0 ** -7 * torch.maximum(want.abs(), want.abs().max() * 2.0 ** -8)
    return dict(max_abs_err=err.max().item(), over_tol=int((err > tol).sum()),
                same_bits=(got == want).float().mean().item())

def check_cog_hf_kernels():
    """The CogVideoX block's three kernels at cogvideox-5b-hf's shapes (batch
    2 for the guidance pair, 17,776 joint tokens, 48 heads of 64; C = 3072
    and 12,288) on random inputs, against their plain versions
    (``_one_rounding``; in-place calls on a copy) and themselves (the same
    bits again); timed beside the plain version and the bytes bound. Yields
    (row, t_ops, t_bytes)."""
    from dvdx_tpu_torch.models.cogvideox import CogVideoXConfig, rope_tables
    from dvdx_tpu_torch.models.layers import LayerNorm

    gen = torch.Generator(device="cuda").manual_seed(2468)
    b, s, h, d, c, t = 2, COG_HF_TOKENS, 48, 64, 3072, 226
    qkv = randn((b, s, 3, h, d), gen, 2.0, 0.5)
    norms = []
    for _ in range(2):
        n = LayerNorm(d, eps=1e-6).to("cuda").bfloat16().requires_grad_(False)
        n.weight.copy_(randn((d,), gen, 0.05, 1.0))
        n.bias.copy_(randn((d,), gen, 0.05))
        norms.append(n)
    cos, sin = (x[:, None].cuda() for x in rope_tables(CogVideoXConfig(), 13, 30, 45))
    emb6 = randn((b, 1, 6 * c), gen, 0.5)
    cases = (("qk_norm_rope", "joint_qk", (qkv[:, :, 0], qkv[:, :, 1], *norms, cos, sin, t)),
             ("bias_gelu", "ff_proj_in", (randn((b, s, 4 * c), gen, 1.5),
                                          randn((4 * c,), gen, 0.05))),
             ("gated_residual", "to_out_and_ff_proj_out", (
                 randn((b, s, c), gen, 4.0), randn((b, s, c), gen), randn((c,), gen, 0.05),
                 emb6[..., 2 * c:3 * c], emb6[..., 5 * c:], t)))
    sites = cog_hf_kernel_sites()
    for name, label, args in cases:
        mod, attr, plain = sites[name]
        kern = getattr(mod, attr)
        with torch.inference_mode():
            out, again, ref = (((x,) if isinstance(x, torch.Tensor) else x)
                               for x in (fn(*_fresh(name, args)) for fn in (kern, kern, plain)))
            close = [_one_rounding(o, r) for o, r in zip(out, ref)]
            repeat = all(torch.equal(_bits(o), _bits(x)) for o, x in zip(out, again))
            scale = max(r.float().abs().max().item() for r in ref)
            del out, again, ref
            fresh = _fresh(name, args)
            ms = cuda_ms(lambda: kern(*fresh), 10)
            plain_ms = cuda_ms(lambda: plain(*fresh), 2)
            del fresh
        err = max(x["max_abs_err"] for x in close)
        over = sum(x["over_tol"] for x in close)
        same = min(x["same_bits"] for x in close)
        flops, nbytes = cog_hf_cost(name, args)
        bms, bby = bound_ms(flops, nbytes, PEAK_F32_FLOPS)
        ok = bool(np.isfinite(err)) and over == 0 and same >= COG_HF_SAME_BITS and repeat
        row = dict(kernel=name, shape=label, max_abs_err=err, tol=None, max_abs_ref=scale,
                   repeat_bitwise=repeat, ms=ms, plain_ms=plain_ms, library_ms=None,
                   bound_ms=bms, bound_by=bby, main_path=True, ok=ok, bound_ms_parts=None,
                   plain_on=None, over_tol=over, same_bits=same,
                   held_as="each output within one bf16 rounding step, "
                           f">= {COG_HF_SAME_BITS:.0%} the same bits")
        log(f"kernel {name:20s} {label:28s} err={err:.3e} over_one_step={over} "
            f"same_bits={same:.6f} ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.4f} "
            f"({bby}, {100 * bms / ms:.1f}% of it) repeat_bitwise={repeat} "
            f"{'OK' if ok else 'FAIL'}")
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"{name} {label}: kernel disagrees with its plain version "
                                 f"({over} outputs over one rounding step, {same:.6f} the "
                                 f"same bits) or with itself (repeat bitwise: {repeat})")
        yield row, flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    del qkv, norms, cos, sin, emb6
    torch.cuda.empty_cache()


def check_kernels(only=None):
    """Each case's kernel against its plain version (the kernels named in
    ``only``, or all). Returns ({kernel: sums over its main-path shapes, or
    over all its shapes where none is on the path}, rows)."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    sums = {}
    rows = []
    for name, label, mk, kern, plain, lib, (flops, nbytes), main in kernel_cases():
        if only is not None and name not in only:
            continue
        inputs = mk(gen)
        out = kern(*inputs)
        torch.cuda.synchronize()
        sliced, plain_inputs, held = PLAIN_SLICE.get((name, label)), inputs, out
        if sliced is not None:
            plain_inputs, held = sliced[1](inputs), sliced[2](out)
        ref = plain(*plain_inputs)
        compare = COMPARE_AS.get(name)
        if compare is not None:
            held, ref = compare[1](held, inputs), compare[1](ref, plain_inputs)
        err = (held.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        if held.dtype == torch.float32:
            tol = F32_REL_TOL.get(name, F32_REL_TOL_DEFAULT) * max(scale, 1e-6)
        else:
            tol = TOL_ULPS * 2.0 ** -7 * max(scale, 1e-6)
        # the same inputs again must give the same bits (PoI re-execution)
        repeat = torch.equal(out.view(torch.int16), kern(*inputs).view(torch.int16))
        ok = bool(np.isfinite(err)) and err <= tol and repeat
        iters = 5
        ms = cuda_ms(lambda: kern(*inputs), iters)
        plain_ms = cuda_ms(lambda: plain(*plain_inputs), 2)
        lib_ms = cuda_ms(lambda: lib(*inputs), iters) if lib is not None else None
        peak = kernel_peak(name, inputs[0].dtype)
        bms, bby = bound_ms(flops, nbytes, peak)
        parts = BOUND_PARTS.get((name, label))
        row = dict(kernel=name, shape=label, max_abs_err=err, tol=tol,
                   max_abs_ref=scale, repeat_bitwise=repeat, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bms, bound_by=bby, main_path=main, ok=ok,
                   bound_ms_parts=parts, plain_on=None if sliced is None else sliced[0],
                   held_as=None if compare is None else compare[0])
        rows.append(row)
        log(f"kernel {name:20s} {label:28s} err={err:.3e} tol={tol:.3e} "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={'n/a' if lib_ms is None else f'{lib_ms:.4f}'} "
            f"bound_ms={bms:.4f} ({bby}) repeat_bitwise={repeat} {'OK' if ok else 'FAIL'}"
            + ("" if parts is None else " bound_ms_parts=" + json.dumps(parts))
            + ("" if sliced is None else f" plain on {sliced[0]}"))
        del inputs, out, ref, plain_inputs, held
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"{name} {label}: kernel disagrees with its plain "
                                 f"version ({err:.3e} > {tol:.3e}) or with itself "
                                 f"(repeat bitwise: {repeat})")
        _add_sum(sums, row, flops / peak, nbytes / PEAK_BYTES)
    if only is None or set(only) & set(EPILOGUE_KERNELS):
        for row, t_ops, t_bytes in check_bias_epilogue():
            if only is None or row["kernel"] in only:
                rows.append(row)
                _add_sum(sums, row, t_ops, t_bytes)
    if only is None or set(only) & set(COG_HF_PATH):
        for row, t_ops, t_bytes in check_cog_hf_kernels():
            if only is None or row["kernel"] in only:
                rows.append(row)
                _add_sum(sums, row, t_ops, t_bytes)
    summary = {}
    for name in KERNEL_META if only is None else only:
        s = sums.get((name, True)) or sums[(name, False)]
        off = sums.get((name, False))
        if off is not None:
            s["max_abs_err"] = max(s["max_abs_err"], off["max_abs_err"])
        summary[name] = s
    return summary, rows


# --- phases 3-4: the reference check and the main path ------------------------

def read_counts() -> dict:
    from dvdx_tpu_torch.ops.kernels import launch_counts

    return launch_counts()


def reset_counts() -> None:
    from dvdx_tpu_torch.ops.kernels import reset_launch_counts

    reset_launch_counts()


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


def launch_bounds(module, run, f32: bool = False):
    """Run ``run()`` with forward hooks on the layers of ``module`` that hand
    work to a kernel, and sum each kernel's launches and bound from the
    shapes handed to it: {kernel: {"launches": n, "bound_ms": t}}. Each of
    the six model-path kernels' hook counts must equal its own launch counter
    over the run.
    ``f32``: a float32 model, whose layers launch the float32 forms
    (``F32_NAME``), with float32 operands at the float32 peak. The bias
    epilogue is counted too (``bias_epilogue`` / ``bias_epilogue_f32``): a
    dense layer or convolution during whose forward its launch counters rose
    by one adds its output's bound."""
    from dvdx_tpu_torch.models import layers
    from dvdx_tpu_torch.ops.attention import wants_flash
    from dvdx_tpu_torch.ops.kernels import bias_epilogue as be

    acc = {k: [0, 0.0] for k in MODEL_PATH}
    epilogue = [0, 0.0]
    epilogue_before = {}  # layer -> the epilogue's launches before its forward
    chain_ff = [0.0, 0.0]  # the fused block's bound split: chain launch, FF launches
    tail_chain_ff = [0.0, 0.0]  # the fused tail's

    def bound(cost, kernel):
        if not f32:
            return bound_ms(*cost)[0]
        return bound_ms(*f32_cost(cost), kernel_peak(F32_NAME[kernel], torch.float32))[0]

    def add(name, cost):
        acc[name][0] += 1
        acc[name][1] += bound(cost, name)

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
        tail_chain_ff[0] += bound(spatial_chain_cost(n * s, c, hd, ctx.shape[1], n),
                                  "fused_spatial_tail")
        tail_chain_ff[1] += bound(temporal_ff_cost(n * s, c), "fused_spatial_tail")

    def epilogue_launches():
        return be.LAUNCHES + be.F32_LAUNCHES

    def before_layer(mod, args, kwargs):
        epilogue_before[mod] = epilogue_launches()

    def on_layer(mod, args, kwargs, out):
        # the epilogue wrote into the product and returned it
        if epilogue_launches() - epilogue_before.pop(mod) == 1:
            epilogue[0] += 1
            c = out.shape[-1]
            epilogue[1] += bound_ms(*epilogue_cost(out.numel() // c, c,
                                                   kwargs.get("residual") is not None,
                                                   out.dtype.itemsize), PEAK_F32_FLOPS)[0]

    def on_temporal_block(mod, args, kwargs, out):
        x = args[0]
        if mod.fused(x):
            rows, f, c = x[..., 0].numel(), x.shape[1], x.shape[-1]
            add("fused_temporal_block", temporal_block_cost(rows, f, c))
            chain_ff[0] += bound(temporal_chain_cost(rows, f, c), "fused_temporal_block")
            chain_ff[1] += bound(temporal_ff_cost(rows, c), "fused_temporal_block")

    hooks = ((layers.GroupNorm, on_gn), (layers.GEGLUFeedForward, on_ff),
             (layers._FrameAxisAttention, on_frame_attn), (layers.Attention, on_attn),
             (layers.BasicTransformerBlock, on_block),
             (layers._TemporalBlock, on_temporal_block),
             (layers.Dense, on_layer), (layers.Conv, on_layer))
    handles = [m.register_forward_hook(fn, with_kwargs=True)
               for m in module.modules() for cls, fn in hooks if isinstance(m, cls)]
    handles += [m.register_forward_pre_hook(before_layer, with_kwargs=True)
                for m in module.modules() if isinstance(m, (layers.Dense, layers.Conv))]
    before = read_counts()
    run()
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    after = read_counts()
    name = (lambda k: F32_NAME[k]) if f32 else (lambda k: k)
    epilogue_name = EPILOGUE_KERNELS[1 if f32 else 0]
    for k, (n, _) in acc.items():
        k = name(k)
        if after[k] - before[k] != n:
            raise AssertionError(f"{k}: {after[k] - before[k]} launches, "
                                 f"{n} seen by the bound's hooks")
    out = {name(k): {"launches": n, "bound_ms": ms} for k, (n, ms) in acc.items()}
    out[epilogue_name] = {"launches": epilogue[0], "bound_ms": epilogue[1]}
    out[name("fused_temporal_block")].update(bound_ms_chain=chain_ff[0],
                                             bound_ms_ff=chain_ff[1])
    out[name("fused_spatial_tail")].update(bound_ms_chain=tail_chain_ff[0],
                                           bound_ms_ff=tail_chain_ff[1])
    return out


def check_weights(pipe, init_s: float, perturb_s: float) -> dict:
    """Phase 11(a): the full-width weights are the JAX package's. The
    sha256 over every leaf in the flax layout, in the reference's tree
    order (``utils.init.tree_digest``, read back from the card), must equal
    the digest the JAX package derives for zeroscope-v2-576w at seed 0,
    perturbed at seed 99 (``utils.init.REFERENCE_DIGESTS``): this host's
    numpy gave the same SFC64 and default_rng bits, and the copy to the
    card is exact."""
    from dvdx_tpu_torch.utils.init import REFERENCE_DIGESTS, param_bytes, param_count, tree_digest

    t0 = time.perf_counter()
    digest = tree_digest(pipe)
    want = REFERENCE_DIGESTS[("zeroscope-v2-576w", 0, 99)]
    out = {"fast_init_s": init_s, "perturb_s": perturb_s,
           "digest_s": time.perf_counter() - t0, "digest": digest, "expected": want,
           "params": param_count(pipe), "bytes": param_bytes(pipe)}
    log(f"phase 11(a) weights: fast_init {init_s:.2f} s + perturb {perturb_s:.2f} s "
        f"(start-up), {out['params']} params, {out['bytes'] / 2**30:.2f} GiB; digest "
        f"{digest} in {out['digest_s']:.1f} s, the JAX package's {want}: "
        f"{'equal' if digest == want else 'DIFFERENT'}")
    _require(digest == want, "phase 11(a): full-width weights against the JAX package's", out)
    return out


def compare_commits(ts, zs, epss, what: str, smi: str) -> dict:
    """The miner's commitment over one recorded request through the native
    hasher (``utils.native``, the default) and through the plain hashlib
    loop (``use_native=False``): the same leaves and root, each timed on the
    host (the library is built before the clock starts)."""
    from dvdx_tpu_torch.utils import native
    from dvdx_tpu_torch.verify.merkle import MerkleCommitment

    t0 = time.perf_counter()
    native.library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fast = MerkleCommitment(ts, zs, epss)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = MerkleCommitment(ts, zs, epss, use_native=False)
    hashlib_s = time.perf_counter() - t0
    nbytes = 2 * len(ts) + native.host_array(zs).nbytes + native.host_array(epss).nbytes
    out = {"leaves": len(ts), "bytes_hashed": nbytes, "native_s": native_s,
           "hashlib_s": hashlib_s, "build_or_load_s": build_s, "root": fast.root.hex(),
           "hashlib_root": plain.root.hex(), "device": smi}
    log(f"{what} commit ({smi}): native {native_s:.4f} s, hashlib {hashlib_s:.4f} s over "
        f"{nbytes} bytes in {len(ts)} leaves (library built or loaded in {build_s:.2f} s); "
        f"roots {out['root']} / {out['hashlib_root']}")
    _require(fast.leaves == plain.leaves and fast.root == plain.root,
             f"{what}: the native commitment against the hashlib one", out)
    return out


def trace_unet_call(call, smi: str) -> dict:
    """One bf16 UNet call of Request A under ``utils.profiling.trace`` and
    ``span("unet_call")``: the Chrome trace file must exist, hold the
    annotation, and hold at least as many device events of each model-path
    kernel (grouped by ``utils.profile_step.group_of``) as its launch counter
    counted in the call, which must be ``EXPECTED_PER_UNET_CALL``'s;
    ``device_memory()`` beside ``torch.cuda.max_memory_allocated()``."""
    from dvdx_tpu_torch.utils.profile_step import group_of
    from dvdx_tpu_torch.utils.profiling import device_memory, span, trace

    log_dir = os.path.join(REPO_DIR, "build", "unet_call_trace")
    reset_counts()
    with trace(log_dir) as path:
        with span("unet_call"):
            call()
    counts = read_counts()
    events = json.load(open(path))["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            g = group_of(e.get("name", ""))
            kernels[g] = kernels.get(g, 0) + 1
    marks = [e.get("cat") for e in events if e.get("name") == "unet_call"]
    mem = device_memory()
    peak = torch.cuda.max_memory_allocated()
    out = {"trace_bytes": os.path.getsize(path), "annotation": marks,
           "launches": {k: counts[k] for k in MODEL_PATH},
           "device_events": kernels, "device_memory": mem,
           "max_memory_allocated_mb": peak / 2**20}
    log(f"traced UNet call ({smi}): {path} ({out['trace_bytes']} bytes), annotation "
        f"{marks}; launches {json.dumps(out['launches'])}; device events by group "
        f"{json.dumps(kernels)}; device_memory {json.dumps(mem)}, "
        f"max_memory_allocated {peak / 2**20:.1f} MB")
    missing = [k for k in MODEL_PATH
               if counts[k] != EXPECTED_PER_UNET_CALL[k] or kernels.get(k, 0) < counts[k]]
    _require("user_annotation" in marks and not missing,
             f"traced UNet call: the annotation and each kernel's device events {missing}", out)
    _require(mem["peak_mb"] == peak / 2**20 and 0 < mem["in_use_mb"] <= mem["peak_mb"]
             < mem["limit_mb"], "traced UNet call: device_memory", out)
    return out


def run_path(steps_a: int, smi: str):
    from dvdx_tpu_torch.ops import rng
    from dvdx_tpu_torch.ops.scheduler import make_ddim_schedule
    from dvdx_tpu_torch.pipelines.text2video import (build_pipeline, encode_prompts,
                                                     generate)
    from dvdx_tpu_torch.utils.testing import perturb_zero_params, unet_pair_call
    from dvdx_tpu_torch.verify.merkle import MerkleCommitment

    t0 = time.perf_counter()
    pipe = build_pipeline("zeroscope-v2-576w", seed=0, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    perturb_zero_params(pipe, seed=99)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    log(f"path: built zeroscope-v2-576w (the JAX package's fast_init draws, zero "
        f"leaves perturbed) in {t_build:.1f} s; params: "
        f"{sum(p.numel() for p in pipe.parameters()) / 1e9:.3f} B")
    weights = check_weights(pipe, t_init, t_build - t_init)

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
    commit = compare_commits(ts, zs, epss, "request A", smi)
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
    stray = [k for k in F32_KERNELS if launches[k]]
    if stray:
        raise AssertionError(f"request A (bf16) launched float32 kernels: {stray}")

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
    wrong = {k: per_step[k] for k, n in dict(EXPECTED_PER_UNET_CALL,
                                             bias_epilogue=EPILOGUE_PER_UNET_CALL).items()
             if per_step[k] != n}
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
    traced = trace_unet_call(lambda: unet_pair_call(pipe.unet, z, hidden, t), smi)
    return pipe, launches, dict(seconds_per_request=sec_a, steps=steps_a,
                          peak_bytes=peak, root=root_a,
                          video_sha256=hashlib.sha256(video.tobytes()).hexdigest(),
                          seconds_request_b=[s1, s2], seconds_per_step=step_s,
                          launches_request_b=launches_b,
                          launches_per_unet_call=per_step, reexecution=reexec,
                          bound_per_unet_call=unet_bounds,
                          bound_per_vae_frame=vae_bounds, weights=weights,
                          commit=commit, traced_unet_call=traced)


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
    if engine.platform_tag != "torch-cuda":
        raise AssertionError(f"engine platform tag {engine.platform_tag!r} on the card")
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


# --- phases 5-6: the network roles ------------------------------------------

def _round_line(report: dict, wall: float) -> dict:
    """Per-miner summary of a round report."""
    return {"wall_s": wall, "miners": {
        uid: {k: d.get(k) for k in ("failed_check", "cheat", "score", "same_platform",
                                   "regime_atol", "reexec_bitwise", "reexec_max_err",
                                   "video_binding_err", "gen_time_s", "timings_s",
                                   "miner_timings_s")}
        for uid, d in report["miners"].items()}}


def _run_round(net, request_id: str, prompt: str):
    import asyncio

    reset_counts()
    t0 = time.perf_counter()
    loop = asyncio.new_event_loop()
    try:
        report = loop.run_until_complete(net.run_request(request_id, prompt))
    finally:
        loop.close()
    torch.cuda.synchronize()
    return report, time.perf_counter() - t0, read_counts()


def _require(cond: bool, what: str, detail) -> None:
    if not cond:
        raise AssertionError(f"{what}: {json.dumps(detail, default=str)[:4000]}")


def run_network_round(pipe):
    """Phase 5: one validator round over three miners of the full-width
    pipeline on the card (honest, lazy, wrong-video)."""
    from dvdx_tpu_torch.network.mock import build_mock_network
    from dvdx_tpu_torch.network.validator import ValidatorConfig

    cfg = ValidatorConfig(width=576, height=320, num_frames=16, num_steps=25,
                          num_checkpoints=3, sample_size=3, ping_timeout_s=30,
                          timeout_s=600, results_dir=os.path.join(OUT_DIR, "network"))
    net = build_mock_network(n_miners=3, adversaries=["honest", "lazy", "wrong_video"],
                             pipeline=pipe, validator_config=cfg)
    stake = dict(net.ledger.stakes)
    report, wall, counts = _run_round(net, "round-576w",
                                      "a red panda rides a bicycle through a snowy forest")
    line = _round_line(report, wall)
    line["launches"] = counts
    log(f"network round: {json.dumps(line)}")
    miners = report["miners"]
    _require(set(miners) == {"0", "1", "2"}, "network round: miners answered", miners)
    honest, lazy, wrong = miners["0"], miners["1"], miners["2"]
    _require(not honest.get("failed_check") and not honest.get("cheat")
             and all(honest["checks"].values()) and honest["same_platform"] is True
             and honest["reexec_bitwise"] is True and honest["score"] > 0,
             "network round: the honest miner", honest)
    _require(lazy.get("failed_check") == "reexecution" and lazy.get("cheat") is True,
             "network round: the lazy miner", lazy)
    slashed = stake["miner-1"] - int(stake["miner-1"] * cfg.slash_fraction)
    _require(net.ledger.stake_of("miner-1") == slashed, "network round: lazy stake",
             {"before": stake["miner-1"], "after": net.ledger.stake_of("miner-1")})
    _require(wrong.get("failed_check") == "video_binding",
             "network round: the wrong-video miner", wrong)
    status = net.ledger.requests["round-576w"].status
    _require(status == "distributed", "network round: ledger status", status)
    missing = [k for k in MODEL_PATH if counts[k] == 0]
    _require(not missing, "network round: kernels never launched", missing)
    return line


def run_cross_device_round():
    """Phase 6: zeroscope-tiny miners (the rotary style, float32: GroupNorm's
    float32 kernel and GEGLU's float32 pair on the card) on the card, and a
    validator on the CPU with the same weights: the cross-platform regime."""
    from dvdx_tpu_torch.network.mock import build_mock_network
    from dvdx_tpu_torch.network.validator import ValidatorConfig
    from dvdx_tpu_torch.pipelines.text2video import build_pipeline
    from dvdx_tpu_torch.utils.testing import perturb_zero_params

    card = perturb_zero_params(build_pipeline("zeroscope-tiny", seed=0, device="cuda"),
                               seed=99)
    cpu = build_pipeline("zeroscope-tiny", seed=0, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    cfg = ValidatorConfig(sample_size=2, num_checkpoints=3, num_frames=4, width=32,
                          height=32, num_steps=3, ping_timeout_s=30, timeout_s=600,
                          results_dir=os.path.join(OUT_DIR, "network"))
    net = build_mock_network(n_miners=2, adversaries=["honest", "lazy"], pipeline=card,
                             validator_pipeline=cpu, validator_config=cfg)
    report, wall, counts = _run_round(net, "round-tiny-cross", "a blue cube spinning")
    line = _round_line(report, wall)
    line["launches"] = {k: v for k, v in counts.items() if v}
    log(f"cross-device round: miners {net.miners[0].platform_tag}, validator "
        f"{net.validator.engine.platform_tag}: {json.dumps(line)}")
    honest, lazy = report["miners"]["0"], report["miners"]["1"]
    _require(not honest.get("failed_check") and not honest.get("cheat")
             and all(honest["checks"].values()) and honest["same_platform"] is False
             and honest["regime_atol"] == 5e-2 and honest["score"] > 0,
             "cross-device round: the honest miner", honest)
    _require(lazy.get("failed_check") == "reexecution" and lazy.get("cheat") is True
             and lazy["same_platform"] is False and lazy["regime_atol"] == 5e-2,
             "cross-device round: the lazy miner", lazy)
    missing = [k for k in CROSS_DEVICE_PATH if counts[k] == 0]
    _require(not missing, "cross-device round: kernels never launched", missing)
    return line


# --- phase 8: the network as processes over HTTP ------------------------------

SERVICE_PROMPT = "a red panda rides a bicycle through a snowy forest"
SERVICE_GEOMETRY = dict(num_frames=16, height=320, width=576, num_steps=25)
STARTUP_DEADLINE_S = 300.0
REGISTRY_DEADLINE_S = 120.0
ROUND_DEADLINE_S = 600.0
METRICS_DEADLINE_S = 60.0


def _free_ports(n: int):
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
        return [sk.getsockname()[1] for sk in socks]
    finally:
        for sk in socks:
            sk.close()


def write_lpips_checkpoint(path: str, seed: int = 0) -> None:
    """An lpips-package ('alex') state dict (tests/torch_ref.py's LPIPSRef,
    the package's keys) with seeded values: convs N(0, 1 / fan_in), lin
    heads uniform in [0, 0.2) (non-negative), written with torch.save."""
    ref = load_torch_ref().LPIPSRef()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, prm in ref.named_parameters():
            if name.startswith("lin"):
                prm.copy_(torch.rand(prm.shape, generator=gen) * 0.2)
            elif prm.dim() == 4:
                prm.copy_(torch.randn(prm.shape, generator=gen) * prm[0].numel() ** -0.5)
            else:
                prm.zero_()
    torch.save(ref.state_dict(), path)


class Services:
    """The service processes of phase 8, each in its own working directory
    with its output in ``service.log`` there."""

    def __init__(self, root: str, env: dict):
        self.root = root
        self.env = env    # set in every process's environment
        self.procs = {}   # name -> (Popen, cwd, start time)

    def start(self, name: str, argv):
        cwd = os.path.join(self.root, name)
        os.makedirs(cwd, exist_ok=True)
        with open(os.path.join(cwd, "service.log"), "w") as out:
            proc = subprocess.Popen([sys.executable, "-m", "dvdx_tpu_torch", *argv], cwd=cwd,
                                    stdout=out, stderr=subprocess.STDOUT,
                                    env={**os.environ, "PYTHONPATH": REPO_DIR, **self.env})
        self.procs[name] = (proc, cwd, time.perf_counter())

    def log_text(self, name: str) -> str:
        with open(os.path.join(self.procs[name][1], "service.log"), errors="replace") as f:
            return f.read()

    def check_alive(self) -> None:
        for name, (proc, _, _) in self.procs.items():
            if proc.poll() is not None:
                raise AssertionError(f"services: {name} exited with {proc.returncode}; "
                                     f"its output ends:\n{self.log_text(name)[-4000:]}")

    def wait_started(self, markers: dict) -> dict:
        """Seconds from each process's start to its marker in its output."""
        started = {}
        deadline = time.perf_counter() + STARTUP_DEADLINE_S
        while len(started) < len(self.procs):
            self.check_alive()
            for name, (_, _, t0) in self.procs.items():
                if name not in started and markers[name] in self.log_text(name):
                    started[name] = round(time.perf_counter() - t0, 2)
            if time.perf_counter() > deadline:
                raise AssertionError(f"services: not serving after {STARTUP_DEADLINE_S} s: "
                                     f"{sorted(set(self.procs) - set(started))}")
            time.sleep(0.2)
        return started

    def stop(self) -> None:
        for proc, _, _ in self.procs.values():
            if proc.poll() is None:
                proc.terminate()
        for proc, _, _ in self.procs.values():
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=20)


def _http(method: str, url: str, body=None, timeout: float = 120.0):
    """(status, parsed JSON or raw bytes) of one request to a local service."""
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw, status, ctype = r.read(), r.status, r.headers.get_content_type()
    except urllib.error.HTTPError as e:
        raw, status, ctype = e.read(), e.code, e.headers.get_content_type()
    return status, (json.loads(raw) if ctype == "application/json" else raw)


def _poll(services, what: str, fn, deadline_s: float, interval: float = 0.2):
    """fn() until it returns a true value; fails at the deadline or when a
    service process exits."""
    deadline = time.perf_counter() + deadline_s
    while True:
        services.check_alive()
        try:
            got = fn()
        except OSError:  # not serving yet, or busy past the request's timeout
            got = None
        if got:
            return got
        if time.perf_counter() > deadline:
            raise AssertionError(f"services: {what} not within {deadline_s} s")
        time.sleep(interval)


def _compute_apps() -> dict:
    """{pid: MiB} of the card's compute processes, as nvidia-smi lists them
    (its pids are the host's where this process runs in a PID namespace)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout
    apps = {}
    for line in out.strip().splitlines():
        pid, mib = (x.strip() for x in line.split(","))
        apps[int(pid)] = int(mib)
    return apps


def _check_service_memory(pids: dict, apps: dict, reserved: dict) -> dict:
    """Each service holds memory on the card. Where nvidia-smi lists the
    service pids, each must be there, and its MiB is the process's. Where
    the processes run in a PID namespace nvidia-smi does not see into, it
    lists other pids (one, pid 1, holding the memory of them all); then its
    total must cover what the four services and this process hold in their
    caching allocators (``reserved``, bytes, each service's above 0)."""
    if all(pid in apps for pid in pids.values()):
        return {name: apps[pid] for name, pid in pids.items()}
    held = sum(reserved.values()) + torch.cuda.memory_reserved()
    _require(all(reserved[name] > 0 for name in pids) and sum(apps.values()) * 2**20 >= held,
             "services: nvidia-smi shows the services' device memory",
             {"apps_mib": apps, "pids": pids, "reserved_bytes": reserved,
              "this_process_reserved": torch.cuda.memory_reserved()})
    return {"nvidia_smi_total": sum(apps.values()),
            **{name: round(reserved[name] / 2**20) for name in pids}}


def _request_round(svc, api: str, rid: str, prompt: str, what: str):
    """A request through a validator service's REST API: /deposit and
    /submit_prompt, then /status until the round ends; it must end
    ``completed``. -> (/result body, wall seconds from the deposit)."""
    t0 = time.perf_counter()
    for path, body in (("deposit", {"user": "user-1", "request_id": rid, "amount": 1_000_000,
                                    "prompt_hash": hashlib.sha256(prompt.encode()).hexdigest()}),
                       ("submit_prompt", {"request_id": rid, "prompt": prompt})):
        st, resp = _http("POST", f"{api}/{path}", body)
        _require(st == 200, f"{what}: {path}", resp)

    def finished():
        status, body = _http("GET", f"{api}/status/{rid}", timeout=30)
        return body if status == 200 and body["status"] in ("completed", "failed") else None

    status = _poll(svc, "the round", finished, ROUND_DEADLINE_S)
    wall = round(time.perf_counter() - t0, 3)
    st, result = _http("GET", f"{api}/result/{rid}")
    _require(st == 200 and status["status"] == "completed", f"{what}: round status",
             {"status": status, "result": result})
    return result, wall


def run_services(pipe, smi: str, param_cache: str):
    """Phase 8: one validator and three miners of zeroscope-v2-576w as four
    ``python -m dvdx_tpu_torch`` processes on the card (no device flag), each
    with ``DVDX_PARAM_CACHE=param_cache`` (phase 12 wrote the weights there,
    so each loads them instead of drawing), a request through the REST API
    to ``completed``, and each miner's Merkle root against this process's
    kernel path on the same request."""
    import shutil

    from dvdx_tpu_torch.network.base import ScoreBook
    from dvdx_tpu_torch.utils.convert import load_lpips
    from dvdx_tpu_torch.utils.video_io import decode_video
    from dvdx_tpu_torch.verify.merkle import MerkleCommitment
    from dvdx_tpu_torch.verify.spotcheck import StepEngine

    root = os.path.join(REPO_DIR, "build", "services")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    lpips_path = os.path.join(root, "lpips_alex.pth")
    write_lpips_checkpoint(lpips_path)
    results = os.path.join(root, "validator", "results")
    api_port, *miner_ports = _free_ports(4)
    api = f"http://127.0.0.1:{api_port}"
    g = SERVICE_GEOMETRY
    svc = Services(root, {"DVDX_PARAM_CACHE": param_cache})
    out = {"param_cache": param_cache}
    try:
        svc.start("validator", [
            "validator", "--model", "zeroscope-v2-576w", "--perturb",
            "--width", str(g["width"]), "--height", str(g["height"]),
            "--frames", str(g["num_frames"]), "--steps", str(g["num_steps"]),
            "--sample-size", "3", "--num-checkpoints", "3", "--lpips-ckpt", lpips_path,
            "--poll-interval", "0.2", "--api-port", str(api_port),
            "--results-dir", results])
        for i, port in enumerate(miner_ports):
            svc.start(f"miner{i}", ["miner", "--model", "zeroscope-v2-576w", "--perturb",
                                    "--sync-interval", "1", "--port", str(port),
                                    "--validator-api", f"127.0.0.1:{api_port}"])
        pids = {name: proc.pid for name, (proc, _, _) in svc.procs.items()}
        out["startup_s"] = svc.wait_started({name: "REST API at" if name == "validator"
                                             else "serving at" for name in pids})
        out["weights_s"] = {}  # each process's build + perturbation, as it logs it
        for name in pids:
            found = re.search(r"weights in ([0-9.]+) s", svc.log_text(name))
            out["weights_s"][name] = float(found[1]) if found else None
        log(f"services ({smi}): start-up seconds {json.dumps(out['startup_s'])}, of which "
            f"the weights (the cache's load and the perturbation) "
            f"{json.dumps(out['weights_s'])}")

        def miners_registered():
            status, reg = _http("GET", f"{api}/registry", timeout=10)
            ms = {u: n for u, n in reg.items() if n["role"] == "miner"}
            return ms if status == 200 and len(ms) == 3 else None

        miners = _poll(svc, "three miners registered", miners_registered, REGISTRY_DEADLINE_S)
        pins = sorted(n["platform"] for n in miners.values())
        _require(pins == ["torch-cuda"] * 3, "services: miner pins", miners)
        out["nvidia_smi_idle"] = _compute_apps()

        result, out["round_wall_s"] = _request_round(svc, api, "svc-576w", SERVICE_PROMPT,
                                                     "services")
        out["nvidia_smi_after_round"] = _compute_apps()
        per_miner = result["miners"]
        _require(set(per_miner) == set(miners), "services: every miner answered",
                 sorted(per_miner))
        for uid, d in per_miner.items():
            _require(not d.get("failed_check") and not d.get("cheat")
                     and all(d["checks"].values()) and d["same_platform"] is True
                     and d["reexec_bitwise"] is True and d["score"] > 0
                     and d["mdvqs"]["perceptual_metric"] == "lpips-alex"
                     and d["frames_shape"] == [g["num_frames"], g["height"], g["width"], 3],
                     f"services: miner {uid}", d)
        out["miners"] = {uid: {k: d.get(k) for k in (
            "score", "reexec_max_err", "video_binding_err", "gen_time_s", "timings_s",
            "miner_timings_s", "merkle_root")} for uid, d in per_miner.items()}
        for uid, d in out["miners"].items():
            log(f"services ({smi}): miner {uid} timings_s {json.dumps(d['miner_timings_s'])}; "
                f"validator's timings_s {json.dumps(d['timings_s'])}")
        log(f"services ({smi}): round wall {out['round_wall_s']} s (deposit to completed); "
            f"nvidia-smi compute apps (pid: MiB) idle {json.dumps(out['nvidia_smi_idle'])}, "
            f"after the round {json.dumps(out['nvidia_smi_after_round'])}; service pids "
            f"{json.dumps(pids)}, this process {os.getpid()}")

        # a video is served, and its LPIPS on the CPU matches the validator's
        uid0 = sorted(per_miner)[0]
        st, mp4 = _http("GET", f"{api}{per_miner[uid0]['video_url']}")
        _require(st == 200 and isinstance(mp4, bytes) and len(mp4) > 0,
                 "services: /videos", {"status": st})
        frames = decode_video(mp4)
        lp_cpu = load_lpips(lpips_path, device="cpu").consecutive_mean_u8(frames)
        lp_card = per_miner[uid0]["mdvqs"]["perceptual_distance"]
        out["lpips_card_vs_cpu"] = [lp_card, lp_cpu]
        _require(abs(lp_card - lp_cpu) <= 1e-4, "services: lpips on the card vs the CPU",
                 out["lpips_card_vs_cpu"])

        st, weights = _http("GET", f"{api}/weights")
        book = ScoreBook()
        book.load(os.path.join(results, "validator_state.npz"))
        settled = {str(u): w for u, w in book.weights().items()}
        _require(st == 200 and set(weights["weights"]) == set(miners)
                 and weights["weights"] == settled and abs(sum(settled.values()) - 1) < 1e-9,
                 "services: /weights holds the settled scores",
                 {"weights": weights, "npz": settled})

        # every model-path kernel launched in each process (miners: the
        # generation on a pool thread; the validator: re-execution, decode)
        def metrics(name, path):
            def read():
                with open(path) as f:
                    m = json.load(f)
                return m if name == "validator" or m.get("reveals", 0) >= 1 else None
            return _poll(svc, f"{name}'s metrics", read, METRICS_DEADLINE_S)

        dumps = {f"miner{i}": metrics(f"miner{i}", os.path.join(
            root, f"miner{i}", "miner_metrics.json")) for i in range(3)}
        dumps["validator"] = metrics("validator", os.path.join(
            results, "validator_metrics.json"))
        launches = {name: m["kernel_launches"] for name, m in dumps.items()}
        memory_stats = {name: {k: round(v / 2**30, 3) for k, v in m.get("device_memory", {}).items()}
                        for name, m in dumps.items()}
        out["launches"] = launches
        out["device_memory"] = memory_stats
        out["memory_mib"] = _check_service_memory(
            pids, out["nvidia_smi_after_round"],
            {name: m.get("device_memory", {}).get("reserved", 0) for name, m in dumps.items()})
        log(f"services ({smi}): device memory per process, MiB {json.dumps(out['memory_mib'])}; "
            f"torch allocator per process, GiB {json.dumps(memory_stats)}")
        for name, counts in launches.items():
            missing = [k for k in MODEL_PATH if not counts.get(k)]
            _require(not missing, f"services: {name} never launched", missing)
        log(f"services ({smi}): launches per process {json.dumps(launches)}")
    finally:
        svc.stop()

    # this process's kernel path on the same request: the same Merkle root
    reset_counts()
    t0 = time.perf_counter()
    _, zs, epss, ts = StepEngine(pipe).generate_recorded(
        SERVICE_PROMPT, seed=int(result["seed"]), guidance_scale=7.5, **g)
    torch.cuda.synchronize()
    root_here = MerkleCommitment(ts, zs, epss).root.hex()
    counts = read_counts()
    out["in_process"] = {"seconds": round(time.perf_counter() - t0, 3), "root": root_here,
                         "launches": counts}
    roots = {uid: d["merkle_root"] for uid, d in per_miner.items()}
    log(f"services ({smi}): in-process root {root_here} in {out['in_process']['seconds']} s; "
        f"miners' roots {json.dumps(roots)}")
    _require(all(r == root_here for r in roots.values()),
             "services: miners' Merkle roots against the kernel path", roots)
    missing = [k for k in MODEL_PATH if counts[k] == 0]
    _require(not missing, "services: in-process path never launched", missing)
    return out


# --- phase 11(c): shared weights through --params-ckpt --------------------------

PARAMS_CKPT = os.path.join(REPO_DIR, "tests", "data", "zeroscope_tiny_p99_orbax")
CKPT_GEOMETRY = dict(num_frames=4, height=32, width=32, num_steps=4)


def run_params_ckpt(smi: str) -> dict:
    """Phase 11(c): the orbax directory the JAX package's ``save_params``
    wrote from zeroscope-tiny (seed 0, perturbed at seed 99) is read here
    without JAX or orbax and must equal the port's own ``fast_init`` +
    ``perturb_zero_params`` bit for bit; then ``python -m dvdx_tpu_torch
    miner --model zeroscope-tiny --params-ckpt <it>`` on the card runs a
    round with a port validator of the same checkpoint, to ``completed``.
    Where tensorstore does not import, the miner must instead refuse the
    flag with exit 2 and name the module."""
    import shutil

    from dvdx_tpu_torch.models.zoo import get_model_spec
    from dvdx_tpu_torch.pipelines.text2video import build_pipeline, empty_pipeline
    from dvdx_tpu_torch.utils.init import tree_digest
    from dvdx_tpu_torch.utils.testing import perturb_zero_params

    ckpt = PARAMS_CKPT
    try:
        import tensorstore  # noqa: F401
    except ImportError as e:
        proc = subprocess.run([sys.executable, "-m", "dvdx_tpu_torch", "miner", "--model",
                               "zeroscope-tiny", "--params-ckpt", ckpt], capture_output=True,
                              text=True, timeout=120,
                              env={**os.environ, "PYTHONPATH": REPO_DIR})
        log(f"phase 11(c) --params-ckpt: tensorstore does not import on this host ({e}); "
            f"the miner exited {proc.returncode}: {proc.stderr.strip()[-300:]}")
        _require(proc.returncode == 2 and "tensorstore" in proc.stderr,
                 "phase 11(c): --params-ckpt refused without tensorstore", proc.stderr)
        return {"tensorstore": False, "refused_exit": proc.returncode}

    from dvdx_tpu_torch.utils.checkpoint import load_params

    t0 = time.perf_counter()
    loaded = load_params(ckpt, like=empty_pipeline(get_model_spec("zeroscope-tiny"), "cuda"))
    load_s = time.perf_counter() - t0
    own = perturb_zero_params(build_pipeline("zeroscope-tiny", seed=0, device="cuda"), seed=99)
    got, want = tree_digest(loaded), tree_digest(own)
    out = {"tensorstore": True, "load_s": load_s, "digest_loaded": got, "digest_own": want}
    log(f"phase 11(c) --params-ckpt: tensorstore imports; the checkpoint loaded in "
        f"{load_s:.2f} s, digest {got}, the port's fast_init + perturb {want}: "
        f"{'equal' if got == want else 'DIFFERENT'}")
    _require(got == want, "phase 11(c): checkpoint leaves against fast_init + perturb", out)
    del loaded, own

    root = os.path.join(REPO_DIR, "build", "params_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    results = os.path.join(root, "validator", "results")
    api_port, miner_port = _free_ports(2)
    api = f"http://127.0.0.1:{api_port}"
    g = CKPT_GEOMETRY
    svc = Services(root)
    try:
        svc.start("validator", [
            "validator", "--model", "zeroscope-tiny", "--params-ckpt", ckpt,
            "--width", str(g["width"]), "--height", str(g["height"]),
            "--frames", str(g["num_frames"]), "--steps", str(g["num_steps"]),
            "--poll-interval", "0.2", "--api-port", str(api_port), "--results-dir", results])
        svc.start("miner", ["miner", "--model", "zeroscope-tiny", "--params-ckpt", ckpt,
                            "--sync-interval", "1", "--port", str(miner_port),
                            "--validator-api", f"127.0.0.1:{api_port}"])
        out["startup_s"] = svc.wait_started({"validator": "REST API at", "miner": "serving at"})

        def registered():
            status, reg = _http("GET", f"{api}/registry", timeout=10)
            ms = {u: n for u, n in reg.items() if n["role"] == "miner"}
            return ms if status == 200 and len(ms) == 1 else None

        miners = _poll(svc, "the miner registered", registered, REGISTRY_DEADLINE_S)
        result, out["round_wall_s"] = _request_round(svc, api, "ckpt-tiny", "a red ball",
                                                     "phase 11(c)")
        (uid, d), = result["miners"].items()
        _require(set(result["miners"]) == set(miners) and not d.get("cheat")
                 and all(d["checks"].values()) and d["same_platform"] is True
                 and d["reexec_bitwise"] is True and d["score"] > 0,
                 "phase 11(c): the checkpoint miner's round", d)
        out["miner"] = {k: d.get(k) for k in ("score", "reexec_max_err", "merkle_root")}
        log(f"phase 11(c) ({smi}): validator and miner on --params-ckpt, start-up "
            f"{json.dumps(out['startup_s'])} s, round {out['round_wall_s']} s to completed; "
            f"miner {uid}: {json.dumps(out['miner'])}")
    finally:
        svc.stop()
    return out


# --- phase 12: frame-sharded GroupNorm on the card, the weight cache ---------

CACHE_DIR = os.path.join(REPO_DIR, "build", "param_cache")
# Request A's Merkle root on the JAX package's weights with the kernels as they
# stand, held: a change to a kernel's summation order moves it, and such a
# change records its new root here
REQUEST_A_ROOT = "0c3367b4"


def first_frame_sharded_norm_input(pipe):
    """The input and settings of the first frame-sharded GroupNorm (one whose
    statistics span the frames: ``GroupNorm.over_frames``) of Request A's
    first batched UNet call."""
    import dvdx_tpu_torch.models.layers as layers
    from dvdx_tpu_torch.ops import rng
    from dvdx_tpu_torch.ops.scheduler import make_ddim_schedule
    from dvdx_tpu_torch.pipelines.text2video import encode_prompts
    from dvdx_tpu_torch.utils.testing import unet_pair_call

    seen = []
    saved = layers.GroupNorm.over_frames

    def record(self, x):
        if not seen:
            seen.append((x.clone(), self.weight, self.bias, self.groups, self.eps, self.act))
        return saved(self, x)

    hidden = encode_prompts(pipe, ["", SERVICE_PROMPT])
    z = rng.video_noise(rng.base_key(7), 16, (40, 72, 4), device="cuda")[None].bfloat16()
    layers.GroupNorm.over_frames = record
    try:
        unet_pair_call(pipe.unet, z, hidden, int(make_ddim_schedule(25).timesteps[0]))
    finally:
        layers.GroupNorm.over_frames = saved
    return seen[0]


def split_norm(x, gamma, beta, groups, eps, act, parts: int = 2):
    """The frame-sharded GroupNorm's ranks in one process: moments-out of
    each part of x's frames, the float64 sums added (the all-reduce),
    moments-in of each part with the global moments, concatenated."""
    from dvdx_tpu_torch.ops import groupnorm as gn

    pieces = [p.contiguous() for p in x.chunk(parts, dim=1)]
    outs = [gn.group_norm_moments(p, groups) for p in pieces]
    sums = sum(o[0] for o in outs)
    moments = tuple((sums / sum(o[1] for o in outs)).float())
    y = torch.cat([gn.group_norm_apply(p, gamma, beta, moments, groups=groups, eps=eps,
                                       act=act) for p in pieces], dim=1)
    return y, moments


def _gloo_rank(rank, world, device, x, gamma, beta, groups, eps, act):
    """One rank of the frame-sharded GroupNorm at ``world`` gloo ranks on the
    one card: ``group_norm_act_sharded`` (the entry the cp_* strategies'
    frame-sharded norms call) on this rank's frames of x, its launch counts
    set to 0 just before and read just after."""
    from dvdx_tpu_torch.ops import groupnorm as gn
    from dvdx_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dvdx_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((1, 1, world), device="cuda")
    fl = x.shape[1] // world
    mine = x[:, rank * fl:(rank + 1) * fl].cuda().contiguous()
    gamma, beta = gamma.cuda(), beta.cuda()
    torch.cuda.synchronize()
    reset_launch_counts()
    y = gn.group_norm_act_sharded(mine, gamma, beta, groups=groups, eps=eps, act=act,
                                  group=mesh.group(("seq",)), group_size=world)
    torch.cuda.synchronize()
    return {"y": y.cpu(), "launches": launch_counts()}


def gloo_ranks(x, gamma, beta, groups, eps, act, world: int = 2) -> dict:
    """The frame-sharded GroupNorm at two gloo ranks on the one card (NCCL
    refuses two ranks on one device): two processes, each with its half of
    the frames on the card, the float64 sums all-reduced by gloo. Raises
    where a rank fails."""
    from dvdx_tpu_torch.parallel.mesh import run_ranks

    t0 = time.perf_counter()
    ranks = run_ranks(_gloo_rank, world, args=(x.cpu(), gamma.detach().cpu(),
                                               beta.detach().cpu(), groups, eps, act),
                      device="cpu", timeout_s=180,
                      workdir=os.path.join(REPO_DIR, "build", "gloo_ranks"))
    return {"seconds": time.perf_counter() - t0,
            "y": torch.cat([r["y"] for r in ranks], dim=1).cuda(),
            "launches_per_rank": [r["launches"] for r in ranks]}


def run_sharded_and_cache(pipe, smi: str) -> dict:
    """Phase 12: (a) the frame-sharded GroupNorm's two entries on Request
    A's first frame-sharded GroupNorm input, its frames split in two halves
    in this process (the launch counts set to 0 just before, read just
    after), against the plain version of the whole tensor; (b) the
    ``DVDX_PARAM_CACHE`` cache of zeroscope-v2-576w written and hit, the
    hit's digest after the perturbation held to ``REFERENCE_DIGESTS``
    (the file stays for phase 8's services); (c) ``group_norm_act_sharded``
    itself at two gloo ranks on the card (each entry launched once a rank),
    against the split of (a) and the plain version: its ranks' launches are
    the ``kernels`` line's."""
    import shutil

    from dvdx_tpu_torch.ops import groupnorm as gn
    from dvdx_tpu_torch.pipelines.text2video import build_pipeline, param_cache_path
    from dvdx_tpu_torch.models.zoo import get_model_spec
    from dvdx_tpu_torch.utils.bridge import load_flat_npz
    from dvdx_tpu_torch.utils.init import REFERENCE_DIGESTS, tree_digest
    from dvdx_tpu_torch.utils.testing import perturb_zero_params

    out = {}
    x, gamma, beta, groups, eps, act = first_frame_sharded_norm_input(pipe)
    kw = dict(groups=groups, eps=eps, act=act)
    reset_counts()
    y, moments = split_norm(x, gamma, beta, groups, eps, act)
    torch.cuda.synchronize()
    launches = read_counts()
    sums, count = gn._moment_sums(x.reshape(x.shape[0], -1, x.shape[-1]).float(), groups)
    plain_moments = (sums / count).float()
    want = gn.group_norm_act_plain(x, gamma, beta, moments=tuple(plain_moments), **kw)
    err = (y.float() - want.float()).abs().max().item()
    tol = TOL_ULPS * 2.0 ** -7 * want.float().abs().max().item()
    fused = gn.group_norm_act(x, gamma, beta, **kw)
    again, _ = split_norm(x, gamma, beta, groups, eps, act)
    out["split"] = {
        "shape": list(x.shape), "groups": groups, "eps": eps, "act": act,
        "launches": {k: launches[k] for k in SHARDED_GN_PATH},
        "other_launches": {k: v for k, v in launches.items() if v and k not in SHARDED_GN_PATH},
        "moments_bitwise": torch.equal(torch.stack(moments), plain_moments),
        "max_abs_err": err, "tol": tol, "repeat_bitwise": torch.equal(y, again),
        "vs_fused_max_abs_err": (y.float() - fused.float()).abs().max().item(),
        "split_ms": cuda_ms(lambda: split_norm(x, gamma, beta, groups, eps, act), 5),
        "fused_ms": cuda_ms(lambda: gn.group_norm_act(x, gamma, beta, **kw), 5)}
    log(f"phase 12(a) ({smi}): frame-sharded GroupNorm, two halves of "
        f"{json.dumps(out['split'])}")
    _require(all(launches[k] >= 1 for k in SHARDED_GN_PATH) and not out["split"]["other_launches"]
             and out["split"]["moments_bitwise"] and np.isfinite(err) and err <= tol
             and out["split"]["repeat_bitwise"],
             "phase 12(a): the two-half split against the whole", out["split"])

    # (b) the weight cache, written then hit
    name = "zeroscope-v2-576w"
    shutil.rmtree(CACHE_DIR, ignore_errors=True)
    saved = os.environ.get("DVDX_PARAM_CACHE")
    os.environ["DVDX_PARAM_CACHE"] = CACHE_DIR
    try:
        path = param_cache_path(get_model_spec(name), 0)
        timing = {}
        for what in ("miss", "hit"):
            t0 = time.perf_counter()
            built = build_pipeline(name, seed=0, device="cuda")
            torch.cuda.synchronize()
            timing[what] = time.perf_counter() - t0
            if what == "miss":
                del built
                torch.cuda.empty_cache()
    finally:
        if saved is None:
            os.environ.pop("DVDX_PARAM_CACHE")
        else:
            os.environ["DVDX_PARAM_CACHE"] = saved
    # where a hit's time goes: the file read alone, then the npz parse into
    # host tensors (the rest of the hit is the empty modules and the copies
    # to the card)
    t0 = time.perf_counter()
    with open(path, "rb") as f:
        while f.read(1 << 26):
            pass
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree = load_flat_npz(path)
    load_npz_s = time.perf_counter() - t0
    del tree
    t0 = time.perf_counter()
    perturb_zero_params(built, seed=99)
    torch.cuda.synchronize()
    perturb_s = time.perf_counter() - t0
    digest = tree_digest(built)
    del built
    torch.cuda.empty_cache()
    want_digest = REFERENCE_DIGESTS[(name, 0, 99)]
    out["cache"] = {"file": os.path.basename(path), "bytes": os.path.getsize(path),
                    "miss_s": timing["miss"], "hit_s": timing["hit"], "perturb_s": perturb_s,
                    "file_read_s": read_s, "file_read_gbps": os.path.getsize(path) / read_s / 1e9,
                    "load_flat_npz_s": load_npz_s,
                    "digest": digest, "digest_equal": digest == want_digest}
    log(f"phase 12(b) ({smi}): DVDX_PARAM_CACHE {json.dumps(out['cache'])}")
    _require(digest == want_digest, "phase 12(b): the cache hit's weights", out["cache"])

    # (c) the port's entry at two gloo ranks
    ranks = gloo_ranks(x, gamma, beta, groups, eps, act)
    got = ranks.pop("y")
    per_rank = ranks.pop("launches_per_rank")
    ranks["launches_per_rank"] = [{k: r[k] for k in SHARDED_GN_PATH} for r in per_rank]
    ranks["other_launches"] = [{k: v for k, v in r.items() if v and k not in SHARDED_GN_PATH}
                               for r in per_rank]
    ranks["launches"] = {k: sum(r[k] for r in per_rank) for k in SHARDED_GN_PATH}
    ranks["max_abs_err_vs_plain"] = (got.float() - want.float()).abs().max().item()
    ranks["bitwise_vs_in_process_split"] = torch.equal(got, y)
    out["gloo_ranks"] = ranks
    log(f"phase 12(c) ({smi}): group_norm_act_sharded at two gloo ranks on the one card: "
        f"{json.dumps(ranks)}")
    _require(all(r == {k: 1 for k in SHARDED_GN_PATH} for r in ranks["launches_per_rank"])
             and not any(ranks["other_launches"])
             and (ranks["bitwise_vs_in_process_split"] or ranks["max_abs_err_vs_plain"] <= tol),
             "phase 12(c): group_norm_act_sharded at two gloo ranks", ranks)
    del x, y, again, want, fused, got
    torch.cuda.empty_cache()
    return out


# --- phase 7: zeroscope-v2-xl from a full-scale checkpoint -------------------

# zeroscope's architecture in tests/torch_ref.py's (diffusers key names)
# terms, as benchmarks/convert_fullscale.py gives it
FULL_UNET = dict(in_channels=4, out_channels=4, block_out_channels=(320, 640, 1280, 1280),
                 layers_per_block=2, cross_levels=(True, True, True, False), head_dim=64,
                 cross_dim=1024, groups=32, n_temp_convs=4)
FULL_VAE = dict(latent_ch=4, block_out_channels=(128, 256, 512, 512), layers_per_block=2,
                groups=32, mid_attention=True)
FULL_TEXT = dict(hidden=1024, layers=23, heads=16, inner=4096, positions=77)
XL = dict(num_frames=24, height=576, width=1024, num_steps=50, guidance_scale=7.5)
XL_SEGMENT_STEPS = 10
XL_CHECKS = [11, 29, 49]  # the revealed steps bench.py picks for 50 steps
# launches per cfg_split UNet call at XL (batch 1, 24 frames, latent 72x128):
# flash in the 15 spatial transformers of levels 0-2 (level 2's 576 tokens
# pass S >= 512 at XL, not at 576x320), the rest as EXPECTED_PER_UNET_CALL
XL_EXPECTED_PER_UNET_CALL = dict(EXPECTED_PER_UNET_CALL, flash_attention=15)
VAE_GN_PER_FRAME = 30  # GroupNorm launches of one frame's decode


def clip_text_state_dict(vocab: int, hidden: int, layers: int, heads: int, inner: int,
                         positions: int, gen: torch.Generator, device) -> dict:
    """A transformers CLIPTextModel state dict by its key names and shapes:
    LayerNorm scales 1, biases 0, every other tensor N(0, 0.02^2) from
    ``gen``, float32 on ``device``."""
    shapes = {"text_model.embeddings.token_embedding.weight": (vocab, hidden),
              "text_model.embeddings.position_embedding.weight": (positions, hidden)}
    for i in range(layers):
        p = f"text_model.encoder.layers.{i}"
        for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
            shapes[f"{p}.self_attn.{proj}.weight"] = (hidden, hidden)
            shapes[f"{p}.self_attn.{proj}.bias"] = (hidden,)
        shapes.update({f"{p}.layer_norm1.weight": (hidden,), f"{p}.layer_norm1.bias": (hidden,),
                       f"{p}.mlp.fc1.weight": (inner, hidden), f"{p}.mlp.fc1.bias": (inner,),
                       f"{p}.mlp.fc2.weight": (hidden, inner), f"{p}.mlp.fc2.bias": (hidden,),
                       f"{p}.layer_norm2.weight": (hidden,), f"{p}.layer_norm2.bias": (hidden,)})
    shapes["text_model.final_layer_norm.weight"] = (hidden,)
    shapes["text_model.final_layer_norm.bias"] = (hidden,)
    out = {}
    for key, shape in shapes.items():
        if "layer_norm" in key:
            out[key] = torch.full(shape, 1.0 if key.endswith("weight") else 0.0, device=device)
        elif key.endswith("bias"):
            out[key] = torch.zeros(shape, device=device)
        else:
            out[key] = torch.randn(shape, generator=gen, device=device) * 0.02
    return out


def load_torch_ref():
    """tests/torch_ref.py (the diffusers / lpips architectures with their
    state-dict keys), loaded by its path: another installed package may be
    named "tests"."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_ref", os.path.join(REPO_DIR, "tests", "torch_ref.py"))
    torch_ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(torch_ref)
    return torch_ref


def write_synthetic_checkpoint(root: str, unet_kw: dict, vae_kw: dict, text_kw: dict,
                               words, device, seed: int = 0) -> int:
    """A diffusers checkpoint directory of the given architecture with seeded
    random values, as benchmarks/convert_fullscale.py writes one: the UNet
    (tests/torch_ref.py, torch's init scaled by 0.02) in bfloat16, the VAE
    (torch's init, float32), the CLIP text tower (``clip_text_state_dict``,
    float32), all as safetensors, and a ``tokenizer/`` of a BPE trained on
    ``words`` whose BOS / EOS ids the text config names. Returns the bytes
    written."""
    from dvdx_tpu_torch.models.tokenizer import build_test_vocab, write_tokenizer_files
    from dvdx_tpu_torch.utils.convert import write_safetensors

    torch_ref = load_torch_ref()

    def component(sub, cfg, tensors, weights="diffusion_pytorch_model.safetensors"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump(cfg, f)
        return write_safetensors(os.path.join(root, sub, weights), tensors)

    torch.manual_seed(seed)
    with torch.device(device), torch.no_grad():
        unet = torch_ref.UNet3DConditionModelRef(**unet_kw)
        for p in unet.parameters():
            p.mul_(0.02)
    nbytes = component("unet", {
        "in_channels": 4, "out_channels": 4,
        "block_out_channels": list(unet_kw["block_out_channels"]),
        "layers_per_block": unet_kw["layers_per_block"],
        "attention_head_dim": unet_kw["head_dim"],
        "cross_attention_dim": unet_kw["cross_dim"], "norm_num_groups": unet_kw["groups"],
        "norm_eps": 1e-5, "down_block_types": [
            "CrossAttnDownBlock3D" if c else "DownBlock3D" for c in unet_kw["cross_levels"]]},
        {k: v.to(torch.bfloat16) for k, v in unet.state_dict().items()})
    del unet
    with torch.device(device):
        vae = torch_ref.AutoencoderKLRef(**vae_kw)
    nbytes += component("vae", {
        "latent_channels": vae_kw["latent_ch"],
        "block_out_channels": list(vae_kw["block_out_channels"]),
        "layers_per_block": vae_kw["layers_per_block"], "norm_num_groups": vae_kw["groups"],
        "scaling_factor": 0.18215}, vae.state_dict())
    del vae
    vocab, merges = build_test_vocab(words)
    write_tokenizer_files(os.path.join(root, "tokenizer"), vocab, merges)
    v = len(vocab)  # build_test_vocab puts BOS and EOS last
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    nbytes += component("text_encoder", {
        "vocab_size": v, "hidden_size": text_kw["hidden"],
        "intermediate_size": text_kw["inner"], "num_hidden_layers": text_kw["layers"],
        "num_attention_heads": text_kw["heads"],
        "max_position_embeddings": text_kw["positions"], "hidden_act": "gelu",
        "layer_norm_eps": 1e-5, "bos_token_id": v - 2, "eos_token_id": v - 1,
        "pad_token_id": v - 1},
        clip_text_state_dict(v, gen=gen, device=device, **text_kw), "model.safetensors")
    with open(os.path.join(root, "model_index.json"), "w") as f:
        json.dump({"_class_name": "TextToVideoSDPipeline",
                   "note": "synthetic: zeroscope's architecture, seeded random values"}, f)
    return nbytes


# plain flash over batch chunks whose f32 logits stay under this
PLAIN_LOGITS_BYTES = 4e9


def path_kernel_sites():
    """{kernel: (module whose global name the layers call, that name, plain
    version)} for the six kernels of the model path and the bias epilogue
    (which writes into its first argument, ``IN_PLACE``); plain flash runs
    in batch chunks (at XL's level 0 its logits would take 40 GB at once)."""
    from dvdx_tpu_torch.models import layers
    from dvdx_tpu_torch.ops import attention
    from dvdx_tpu_torch.ops import groupnorm as gn
    from dvdx_tpu_torch.ops.kernels import bias_epilogue as be
    from dvdx_tpu_torch.ops.kernels import flash_attention as fa
    from dvdx_tpu_torch.ops.kernels import geglu_ff as gf
    from dvdx_tpu_torch.ops.kernels import spatial_tail as st
    from dvdx_tpu_torch.ops.kernels import temporal_attention as ta
    from dvdx_tpu_torch.ops.kernels import temporal_block as tb

    def flash_plain(q, k, v, scale=None):
        per_entry = q.shape[2] * q.shape[1] * k.shape[1] * 4
        step = max(1, int(PLAIN_LOGITS_BYTES // per_entry))
        return torch.cat([fa.flash_attention_plain(q[i:i + step], k[i:i + step],
                                                   v[i:i + step], scale)
                          for i in range(0, q.shape[0], step)])

    return {"flash_attention": (attention, "flash_attention", flash_plain),
            "temporal_attention": (layers, "temporal_attention", ta.temporal_attention_plain),
            "geglu_ff": (layers, "geglu_ff", gf.geglu_ff_plain),
            "group_norm_act": (layers, "group_norm_act", gn.group_norm_act_plain),
            "fused_spatial_tail": (layers, "fused_spatial_tail", st.fused_spatial_tail_plain),
            "fused_temporal_block": (layers, "fused_temporal_block",
                                     tb.fused_temporal_block_plain),
            "bias_epilogue": (layers, "bias_epilogue", be.bias_epilogue_plain)}


# the path's wrappers that write their result into their first argument (and
# whose plain version does too): the recorder and each held call take a copy
# of it
IN_PLACE = ("bias_epilogue", "bias_gelu", "gated_residual")
# of those, the ones held to their plain version bit for bit
BITWISE = ("bias_epilogue",)


def _fresh(name, args):
    """args, with the first one copied where the kernel ``name`` writes into
    it."""
    return (args[0].clone(), *args[1:]) if name in IN_PLACE else args


@contextlib.contextmanager
def swapped_kernels(make, sites=None):
    """Within the block, each model-path wrapper (of ``sites``, by default
    ``path_kernel_sites()``), where the layers call it, is make(kernel,
    wrapper, plain version)."""
    sites = path_kernel_sites() if sites is None else sites
    saved = {name: getattr(mod, attr) for name, (mod, attr, _) in sites.items()}
    for name, (mod, attr, plain) in sites.items():
        setattr(mod, attr, make(name, saved[name], plain))
    try:
        yield
    finally:
        for name, (mod, attr, _) in sites.items():
            setattr(mod, attr, saved[name])


def _signature(x):
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), tuple(x.stride()), str(x.dtype)
    if isinstance(x, torch.nn.Module):  # a layer handed to a kernel: its parameters' layout
        return type(x).__name__, tuple((k, _signature(v)) for k, v in x.named_parameters())
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in sorted(x.items()))
    if isinstance(x, (tuple, list)):
        return tuple(_signature(v) for v in x)
    return x


@contextlib.contextmanager
def recorded_kernel_inputs(sites=None):
    """Within the block, the inputs of each model-path kernel's (of
    ``sites``, by default ``path_kernel_sites()``) first call at each
    distinct signature (shapes, strides, dtypes, options) are kept, with
    the number of calls at it: yields {kernel: {signature: [calls, args,
    kwargs]}}. The path changes no kernel input in place but the tensor
    that an ``IN_PLACE`` wrapper writes into, which is kept as a copy; so
    the kept inputs are the ones the kernel was given."""
    seen = {}

    def make(name, kern, plain):
        def call(*args, **kwargs):
            calls = seen.setdefault(name, {})
            sig = _signature((args, kwargs))
            if sig not in calls:
                calls[sig] = [0, _fresh(name, args), kwargs]
            calls[sig][0] += 1
            return kern(*args, **kwargs)
        return call

    with swapped_kernels(make, sites):
        yield seen


def _random_like(x, gen, key=""):
    """A tensor of x's shape, strides and dtype, with phase 2's
    distributions: activations (rank 3 and up) N(0, 1), weights (2-D)
    N(0, 1/fan_in), biases N(0, 0.1^2), LayerNorm scales ("_s") 1 + N(0,
    0.1^2); broadcast (stride 0) dimensions stay broadcast. Dicts and
    sequences map over their members; anything else is kept."""
    if isinstance(x, dict):
        return {k: _random_like(v, gen, k) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_random_like(v, gen, key) for v in x)
    if not isinstance(x, torch.Tensor):
        return x
    if x.dim() >= 3:
        scale, shift = 1.0, 0.0
    elif x.dim() == 2:
        scale, shift = x.shape[1] ** -0.5, 0.0
    else:
        scale, shift = 0.1, 1.0 if key.endswith("_s") else 0.0
    base = [1 if st == 0 else n for n, st in zip(x.shape, x.stride())]
    values = randn(base, gen, scale, shift, x.dtype)
    if 0 in x.stride():
        return values.expand(x.shape)
    out = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device)
    return out.copy_(values)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """t's bits as integers of its element size (bf16 or float32)."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def hold_recorded(seen, where: str, tag: str = "xl"):
    """Each recorded call's kernel against its plain version (2 bf16 ulps of
    max|plain|, or ``F32_REL_TOL`` of it in float32; bit for bit for the
    ``BITWISE`` epilogue, each call on a copy of the product; and the same
    bits on a second call), on the inputs the path gave it and on random inputs of the
    same shapes and strides (the
    synthetic checkpoint's small UNet weights leave some outputs at their
    bias, which the path's inputs alone would not test), and its time on the
    path's inputs -> ({kernel: {"shapes", "launches", "ms" (kernel ms summed
    over the recorded calls), "max_abs_err"}}, rows)."""
    sites = path_kernel_sites()
    gen = torch.Generator(device="cuda").manual_seed(4321)
    summary, rows = {}, []
    with torch.inference_mode():  # as the path ran them (a float32 cast is no copy)
        _hold_calls(seen, sites, gen, where, summary, rows)
    torch.cuda.empty_cache()
    log(f"{tag}: {where}: {len(rows)} distinct kernel inputs held against their plain "
        f"versions: " + json.dumps(summary))
    return summary, rows


def _hold_calls(seen, sites, gen, where, summary, rows):
    """hold_recorded's loop: fills ``summary`` and ``rows``."""
    for name, calls in seen.items():
        mod, attr, plain = sites[name]
        kern = getattr(mod, attr)
        s = summary.setdefault(name, dict(shapes=0, launches=0, ms=0.0, max_abs_err=0.0))
        for count, args, kwargs in calls.values():
            shapes = [list(a.shape) for a in args if isinstance(a, torch.Tensor)]
            row = dict(where=where, kernel=name, shapes=shapes, calls=count)
            for inputs, (a, kw) in (("path", (args, kwargs)),
                                    ("random", _random_like((args, kwargs), gen))):
                out = kern(*_fresh(name, a), **kw)
                ref = plain(*_fresh(name, a), **kw)
                err = (out.float() - ref.float()).abs().max().item()
                scale = max(ref.float().abs().max().item(), 1e-6)
                bitwise = torch.equal(_bits(out), _bits(ref))
                if name in BITWISE:
                    tol = 0.0
                elif out.dtype == torch.float32:
                    tol = F32_REL_TOL.get(F32_NAME[name], F32_REL_TOL_DEFAULT) * scale
                else:
                    tol = TOL_ULPS * 2.0 ** -7 * scale
                repeat = torch.equal(_bits(out), _bits(kern(*_fresh(name, a), **kw)))
                row.update({f"{inputs}_max_abs_err": err, f"{inputs}_tol": tol,
                            f"{inputs}_bitwise": bitwise, f"{inputs}_repeat_bitwise": repeat})
                del out, ref
                if not (np.isfinite(err) and err <= tol and repeat
                        and (bitwise or name not in BITWISE)):
                    raise AssertionError(
                        f"{where}: {name} at {shapes} on {inputs} inputs: kernel disagrees "
                        f"with its plain version ({err:.3e} > {tol:.3e}, bitwise: {bitwise}) "
                        f"or with itself (repeat bitwise: {repeat})")
                s["max_abs_err"] = max(s["max_abs_err"], err)
            row["ms"] = cuda_ms(lambda: kern(*args, **kwargs), 3)
            rows.append(row)
            s["shapes"] += 1
            s["launches"] += count
            s["ms"] += count * row["ms"]


FULL_CKPT = os.path.join(REPO_DIR, "build", "synthetic_xl")


def write_full_checkpoint(root: str) -> dict:
    """The synthetic checkpoint at zeroscope's full architecture that phases
    13 and 7 load, written under ``root`` (anything there first removed)."""
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    nbytes = write_synthetic_checkpoint(root, FULL_UNET, FULL_VAE, FULL_TEXT,
                                        F32_PROMPT.split() * 3, "cuda")
    torch.cuda.empty_cache()
    return {"checkpoint_bytes": nbytes, "checkpoint_write_s": time.perf_counter() - t0}


def run_xl(root: str, written: dict, smi: str):
    """Phase 7: zeroscope-v2-xl from the full-scale synthetic checkpoint at
    ``root`` (``written``: its bytes and write seconds), deleted once loaded:
    the XL PoI request, the CLI's segmented runner on the same inputs (the
    same bits), 3 re-executed steps, tiled against full-frame decode of one
    frame, and the command line run on the card."""
    import shutil

    from dvdx_tpu_torch.models.vae import decode_frame_spatially_tiled, decode_frames_tiled
    from dvdx_tpu_torch.ops import rng
    from dvdx_tpu_torch.pipelines.text2video import (build_segmented_runner, encode_prompts,
                                                     resolve_pipeline, to_uint8)
    from dvdx_tpu_torch.utils.testing import REFERENCE_RELRMS_TOL, relative_rms
    from dvdx_tpu_torch.utils.video_io import decode_video
    from dvdx_tpu_torch.verify.merkle import MerkleCommitment
    from dvdx_tpu_torch.verify.spotcheck import StepEngine, verify_revealed_steps

    prompt = F32_PROMPT
    out = dict(written)
    nbytes = written["checkpoint_bytes"]
    try:
        t0 = time.perf_counter()
        pipe = resolve_pipeline(root)
        torch.cuda.synchronize()
        out["convert_load_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["params"] = {f"{name}_params": sum(p.numel() for p in module.parameters())
                     for name, module in (("unet", pipe.unet), ("text", pipe.text_encoder),
                                          ("vae_dec", pipe.vae_decoder))}
    log(f"xl: synthetic checkpoint {nbytes / 1e9:.3f} GB written in "
        f"{out['checkpoint_write_s']:.1f} s; converted and loaded by resolve_pipeline in "
        f"{out['convert_load_s']:.1f} s; params {json.dumps(out['params'])}; tokenizer "
        f"{type(pipe.tokenizer).__name__}")
    _require(out["params"]["unet_params"] > 1.3e9 and pipe.tokenizer is not None,
             "xl: checkpoint", out)

    engine = StepEngine(pipe)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    timings = {}
    video, zs, epss, ts = engine.generate_recorded(
        prompt, seed=7, cfg_split=True, segment_steps=XL_SEGMENT_STEPS, timings=timings, **XL)
    sec = time.perf_counter() - t0
    launches = read_counts()
    root_hex = MerkleCommitment(ts, zs, epss).root.hex()
    out["commit"] = compare_commits(ts, zs, epss, "xl", smi)
    calls = 2 * XL["num_steps"]
    per_call = {k: launches[k] / calls for k in MODEL_PATH}
    per_call["group_norm_act"] = (launches["group_norm_act"]
                                  - VAE_GN_PER_FRAME * XL["num_frames"]) / calls
    out["request"] = dict(seconds=sec, peak_bytes=torch.cuda.max_memory_allocated(),
                          root=root_hex, timings_s=timings, launches=launches,
                          launches_per_unet_call=per_call)
    log(f"xl request: video {tuple(video.shape)} {video.dtype}, {XL['num_steps']} steps, "
        f"cfg_split, segments of {XL_SEGMENT_STEPS}: {sec:.2f} s, peak memory "
        f"{out['request']['peak_bytes'] / 2**30:.2f} GiB, merkle root {root_hex} over "
        f"{len(ts)} leaves; launches per UNet call {json.dumps(per_call)}")
    _require(video.shape == (XL["num_frames"], XL["height"], XL["width"], 3)
             and video.dtype == np.uint8
             and float(np.std(video)) > 0 and len(ts) == XL["num_steps"]
             and bool(torch.isfinite(zs.float()).all() and torch.isfinite(epss.float()).all()),
             "xl request: output", out["request"])
    _require(per_call == {k: float(n) for k, n in XL_EXPECTED_PER_UNET_CALL.items()},
             "xl request: launches per UNet call", per_call)
    # each kernel's bound summed over one cfg_split UNet call (the cond half
    # of the first step)
    hidden = encode_prompts(pipe, ["", prompt])
    z0 = zs[0][None].cuda()
    timestep = torch.full((1,), int(ts[0]), dtype=torch.int32, device=z0.device)

    eps = {}

    def one_call(key):
        with torch.inference_mode():
            eps[key] = pipe.unet(z0, timestep, hidden[1:2]).float()
    with recorded_kernel_inputs() as seen_unet:
        out["bound_per_unet_call"] = launch_bounds(pipe.unet, lambda: one_call("kernels"))
    log(f"xl: bound per cfg_split UNet call {json.dumps(out['bound_per_unet_call'])}")
    _require(out["bound_per_unet_call"]["bias_epilogue"]["launches"] == EPILOGUE_PER_UNET_CALL,
             "xl: bias_epilogue launches per UNet call", out["bound_per_unet_call"])
    # every input that call handed a kernel, held against the plain version;
    # then the whole call through the plain versions
    out["held_per_unet_call"], held_rows = hold_recorded(seen_unet, "unet call")
    del seen_unet
    _require(all(out["held_per_unet_call"][k]["launches"]
                 == out["bound_per_unet_call"][k]["launches"] for k in MODEL_PATH),
             "xl: recorded launches differ from the hooks'", out["held_per_unet_call"])
    with swapped_kernels(lambda name, kern, plain: plain):
        one_call("plain")
    unet_dist = relative_rms(eps["kernels"], eps["plain"])
    del eps
    torch.cuda.empty_cache()
    log(f"xl: one cfg_split UNet call, kernels against plain versions on the card: "
        f"relative RMS {unet_dist:.5f} (tolerance {REFERENCE_RELRMS_TOL})")
    _require(unet_dist <= REFERENCE_RELRMS_TOL, "xl: UNet call against the plain path",
             unet_dist)

    # the CLI's path on the same inputs: the same step program, so the same bits
    ids = torch.from_numpy(pipe.tokenize(["", prompt])).long()
    run = build_segmented_runner(pipe, segment_steps=XL_SEGMENT_STEPS, cfg_split=True, **XL)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    video_cli = to_uint8(run(ids, rng.base_key(7))).cpu().numpy()
    sec_cli = time.perf_counter() - t0
    peak_cli = torch.cuda.max_memory_allocated()

    # re-execution of 3 revealed steps: the validator's XL audit
    leaves = {i: (int(ts[i]), zs[i], epss[i]) for c in XL_CHECKS for i in (c, c + 1)
              if i < len(ts)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, z_next = verify_revealed_steps(engine, prompt, "", leaves, XL_CHECKS,
                                            XL["num_steps"], XL["guidance_scale"],
                                            same_platform=True, atol=1e-4, rtol=2.0 ** -7,
                                            cfg_split=True)
    torch.cuda.synchronize()
    reexec_s = time.perf_counter() - t0

    # one frame of the final latent (re-derived by the last check), full frame
    # and in 48 x 48 latent tiles overlapping by 8
    z_final = z_next[XL_CHECKS.index(XL["num_steps"] - 1)].cuda().float()
    z_frame = z_final[0]
    decode = {}
    with torch.inference_mode():
        for name, fn in (("full", lambda: pipe.vae_decoder(z_frame[None])[0]),
                         ("tiled", lambda: decode_frame_spatially_tiled(
                             pipe.vae_decoder, z_frame, tile=48, overlap=8))):
            fn()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            img = fn()
            torch.cuda.synchronize()
            # the decode's own peak, above the weights and tensors already held
            decode[name] = (img, time.perf_counter() - t0,
                            torch.cuda.max_memory_allocated() - resident)
        t0 = time.perf_counter()
        decode_frames_tiled(pipe.vae_decoder, z_final)
        torch.cuda.synchronize()
        decode_24_s = time.perf_counter() - t0
        with recorded_kernel_inputs() as seen_vae:
            pipe.vae_decoder(z_frame[None])
        with swapped_kernels(lambda name, kern, plain: plain):
            plain_frame = pipe.vae_decoder(z_frame[None])[0]
    out["held_vae_frame"], vae_rows = hold_recorded(seen_vae, "vae frame")
    del seen_vae
    vae_dist = relative_rms(decode["full"][0], plain_frame)
    log(f"xl: one frame's decode, kernels against plain versions on the card: relative "
        f"RMS {vae_dist:.5f} (tolerance {REFERENCE_RELRMS_TOL})")
    _require(vae_dist <= REFERENCE_RELRMS_TOL, "xl: decode against the plain path", vae_dist)
    out["plain_path_relative_rms"] = dict(unet_call=unet_dist, vae_frame=vae_dist)
    with open(os.path.join(OUT_DIR, "xl_held_inputs.json"), "w") as f:
        json.dump(held_rows + vae_rows, f, indent=1)
    full, tiled = decode["full"][0], decode["tiled"][0]
    seam = (tiled - full).abs().max().item()
    step_s = (sec_cli - decode_24_s) / XL["num_steps"]
    out.update(cli_path=dict(seconds_per_video=sec_cli, seconds_per_step=step_s,
                             peak_bytes=peak_cli, decode_24_frames_s=decode_24_s,
                             bitwise=bool(np.array_equal(video_cli, video))),
               reexecution=dict(checks=XL_CHECKS, seconds=reexec_s,
                                passed={i: r.passed for i, r in results.items()},
                                bitwise={i: r.bitwise for i, r in results.items()}),
               tiled_decode=dict(full_s=decode["full"][1], tiled_s=decode["tiled"][1],
                                 full_peak_bytes=decode["full"][2],
                                 tiled_peak_bytes=decode["tiled"][2], max_seam_diff=seam,
                                 full_equals_video_frame=bool(np.array_equal(
                                     to_uint8(full).cpu().numpy(), video[0]))))
    log(f"xl cli path (build_segmented_runner): {sec_cli:.2f} s/video, {step_s:.4f} s/step "
        f"(decode of {XL['num_frames']} frames {decode_24_s:.2f} s), peak memory "
        f"{peak_cli / 2**30:.2f} GiB, video bit-identical to the request's: "
        f"{out['cli_path']['bitwise']}")
    log(f"xl re-execution: steps {XL_CHECKS} in {reexec_s:.2f} s, passed "
        f"{out['reexecution']['passed']} bitwise {out['reexecution']['bitwise']}")
    td = out["tiled_decode"]
    log(f"xl decode of one frame: full {td['full_s'] * 1e3:.1f} ms, peak above the resident "
        f"{td['full_peak_bytes'] / 2**30:.3f} GiB; tiled (48, overlap 8) "
        f"{td['tiled_s'] * 1e3:.1f} ms, peak above the resident "
        f"{td['tiled_peak_bytes'] / 2**30:.3f} GiB; "
        f"largest seam difference {seam:.4f}; full frame equals the video's frame 0: "
        f"{td['full_equals_video_frame']}")
    _require(out["cli_path"]["bitwise"], "xl: runner video differs from the request's",
             out["cli_path"])
    _require(all(r.passed and r.bitwise for r in results.values()),
             "xl: re-execution is not bit-identical", out["reexecution"])
    _require(td["full_equals_video_frame"] and np.isfinite(seam),
             "xl: decode of the final latent", td)
    del pipe, engine
    torch.cuda.empty_cache()

    # the command line on the card, with no device flag
    mp4 = os.path.join(OUT_DIR, "cli_tiny.mp4")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "dvdx_tpu_torch", "generate", "--prompt",
                           "a red ball", "--model", "zeroscope-tiny", "--frames", "4",
                           "--out", mp4], cwd=REPO_DIR, capture_output=True, text=True,
                          timeout=600, env={**os.environ, "PYTHONPATH": REPO_DIR})
    out["cli"] = dict(returncode=proc.returncode, seconds=time.perf_counter() - t0,
                      stdout=proc.stdout.strip()[-500:], stderr=proc.stderr.strip()[-2000:])
    log(f"xl cli: python -m dvdx_tpu_torch generate (no --device): rc {proc.returncode} "
        f"in {out['cli']['seconds']:.1f} s: {out['cli']['stdout']}")
    _require(proc.returncode == 0 and os.path.exists(mp4), "xl: cli", out["cli"])
    with open(mp4, "rb") as f:
        frames = decode_video(f.read())
    _require(frames.shape == (4, 32, 32, 3) and "device=" in proc.stdout
             and "device=cpu" not in proc.stdout, "xl: cli video", list(frames.shape))
    return out


# --- phase 13: float32 zeroscope-v2-576w from the full-architecture checkpoint --

F32_PROMPT = "a red panda rides a bicycle through a snowy forest"  # Request A's
# Request A's geometry; 3 of its 25 steps (a float32 CFG step takes about
# 0.7 s)
F32_REQUEST = dict(num_frames=16, height=320, width=576, num_steps=3, guidance_scale=7.5)
F32_CHECKS = [1, 2]  # re-executed steps; 2 is T-1 (the video binding)
# shifts of a tampered eps leaf the validator must refuse: a gross forgery,
# and twice the same-program atol of 1e-4
F32_TAMPER_SHIFTS = (2.0 ** -4, 2e-4)
# the float32 model routes as the bf16 one: the gates read shapes only
F32_EXPECTED_PER_UNET_CALL = {F32_NAME[k]: n for k, n in EXPECTED_PER_UNET_CALL.items()}
# one float32 UNet call through the kernels against the same call through the
# plain versions (relative RMS): each kernel sits within 1e-5 of its plain
# version's max (1e-4 for GroupNorm), both sides in float32 and the library
# ops the same; the call composes about 240 kernel launches and as many
# library ops, whose differences add in quadrature through the residual
# stream, so 1e-4 leaves a factor 10 over one kernel's bound and is still
# 300 times below REFERENCE_RELRMS_TOL's bf16 spread
F32_PLAIN_RELRMS_TOL = 1e-4


def run_float32(root: str, smi: str) -> dict:
    """Phase 13: float32 zeroscope-v2-576w from the full-architecture
    synthetic checkpoint at ``root`` (phase 7's, loaded a second time with
    ``dtype="float32"``): (a) the request (Request A's prompt, seed and
    geometry, 3 steps) twice through ``StepEngine.generate_recorded``, the
    same bits both times; (b) launches per UNet call as the routing says,
    from the request and from one CFG UNet call's hooks; (c) every distinct
    input that call and one frame's decode hand a kernel, held against the
    plain version (1e-5 relative, 1e-4 for GroupNorm; the same bits again);
    (d) that call and that decode through the plain versions; (e) 2
    revealed steps re-executed bit for bit, the video bound, a tampered eps
    leaf refused; (f) load s, s per step, peak memory, one step's device ms
    by group, each float32 kernel's ms over the call beside its bound."""
    from torch.profiler import ProfilerActivity, profile

    from dvdx_tpu_torch.ops.kernels import attention_f32
    from dvdx_tpu_torch.ops.scheduler import make_ddim_schedule
    from dvdx_tpu_torch.pipelines.text2video import cfg_denoise_step, encode_prompts
    from dvdx_tpu_torch.utils.convert import load_diffusers_checkpoint
    from dvdx_tpu_torch.utils.profile_step import breakdown
    from dvdx_tpu_torch.utils.testing import relative_rms, unet_pair_call
    from dvdx_tpu_torch.verify.merkle import MerkleCommitment
    from dvdx_tpu_torch.verify.spotcheck import StepEngine, verify_revealed_steps

    t_phase = time.perf_counter()
    out = {"device": smi}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pipe = load_diffusers_checkpoint(root, dtype="float32")
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    # no leaf cast to bf16 on the way: every parameter float32, and the towers
    # the checkpoint stores in float32 (text, VAE) keep bits bf16 would drop
    modules = (("unet", pipe.unet), ("text", pipe.text_encoder), ("vae_dec", pipe.vae_decoder))
    out["weights"] = dict(
        params={n: sum(p.numel() for p in m.parameters()) for n, m in modules},
        bytes=sum(p.numel() * p.element_size() for _, m in modules for p in m.parameters()),
        dtypes=sorted({str(p.dtype) for _, m in modules for p in m.parameters()}),
        leaves_beyond_bf16={n: sum(int(not torch.equal(p, p.bfloat16().float()))
                                   for p in m.parameters()) for n, m in modules})
    w = out["weights"]
    log(f"float32: zeroscope-v2-576w from the synthetic checkpoint, load_diffusers_checkpoint("
        f"dtype='float32') in {out['load_s']:.1f} s: {w['bytes'] / 1e9:.3f} GB of weights, "
        f"params {json.dumps(w['params'])}, dtypes {w['dtypes']}, leaves with bits below "
        f"bf16's {json.dumps(w['leaves_beyond_bf16'])}")
    _require(w["dtypes"] == ["torch.float32"] and w["params"]["unet"] > 1.3e9
             and w["leaves_beyond_bf16"]["text"] > 0 and w["leaves_beyond_bf16"]["vae_dec"] > 0,
             "phase 13: the float32 weights", w)

    # (a) the request twice, the same bits
    engine = StepEngine(pipe)
    steps, frames = F32_REQUEST["num_steps"], F32_REQUEST["num_frames"]
    runs = []
    for _ in range(2):
        reset_counts()
        attention_f32.TENSOR_CORE_LAUNCHES = attention_f32.FRAMES_LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        timings = {}
        t0 = time.perf_counter()
        video, zs, epss, ts = engine.generate_recorded(F32_PROMPT, seed=7, timings=timings,
                                                       **F32_REQUEST)
        runs.append(dict(video=video, zs=zs, epss=epss, ts=ts,
                         seconds=time.perf_counter() - t0, timings_s=timings,
                         launches=read_counts(), peak_bytes=torch.cuda.max_memory_allocated(),
                         tensor_core_attention=attention_f32.TENSOR_CORE_LAUNCHES,
                         frames_attention=attention_f32.FRAMES_LAUNCHES,
                         root=MerkleCommitment(ts, zs, epss).root.hex()))
    first, again = runs
    same = (torch.equal(_bits(first["zs"]), _bits(again["zs"]))
            and torch.equal(_bits(first["epss"]), _bits(again["epss"]))
            and np.array_equal(first["video"], again["video"]) and first["root"] == again["root"])
    launches = first["launches"]
    per_call = {k: launches[k] / steps for k in F32_KERNELS}
    per_call["group_norm_act_f32"] = (launches["group_norm_act_f32"]
                                      - VAE_GN_PER_FRAME * frames) / steps
    stray = {k: launches[k] for k in MODEL_PATH if launches[k]}
    out["request"] = {k: first[k] for k in ("seconds", "timings_s", "launches", "peak_bytes",
                                            "root")}
    tc_per_call = first["tensor_core_attention"] / steps
    frames_per_call = first["frames_attention"] / steps
    out["request"].update(seconds_again=again["seconds"], bitwise=same,
                          launches_per_unet_call=per_call,
                          tensor_core_attention_per_unet_call=tc_per_call,
                          frames_attention_per_unet_call=frames_per_call)
    log(f"float32 request ({smi}): video {first['video'].shape}, {steps} steps at "
        f"{frames} x {F32_REQUEST['width']}x{F32_REQUEST['height']}: {first['seconds']:.2f} s, "
        f"{again['seconds']:.2f} s again, peak memory {first['peak_bytes'] / 2**30:.2f} GiB; "
        f"merkle roots {first['root']} / {again['root']}, bit-identical={same}; launches per "
        f"UNet call {json.dumps(per_call)}, float32 attentions on the 64-row tensor-core body "
        f"{tc_per_call} and on the short-sequence body {frames_per_call}")
    video, zs, epss, ts = first["video"], first["zs"], first["epss"], first["ts"]
    _require(video.shape == (frames, F32_REQUEST["height"], F32_REQUEST["width"], 3)
             and video.dtype == np.uint8 and float(np.std(video)) > 0 and len(ts) == steps
             and zs.dtype == torch.bfloat16 and epss.dtype == torch.bfloat16
             and bool(torch.isfinite(zs.float()).all() and torch.isfinite(epss.float()).all()),
             "phase 13(a): the request's output", dict(video=list(video.shape), zs=str(zs.dtype)))
    _require(same, "phase 13(a): the request twice", out["request"])
    _require(per_call == {k: float(n) for k, n in F32_EXPECTED_PER_UNET_CALL.items()}
             and not stray, "phase 13(b): launches per UNet call (float32 kernels only)",
             dict(per_call=per_call, bf16_kernels=stray))
    # flash and the fused tail's cross-attention run the 64-row tensor-core
    # body; the 16-frame attentions (frame-axis, and the fused block's two a
    # launch) the short-sequence body
    _require(tc_per_call == EXPECTED_PER_UNET_CALL["flash_attention"]
             + EXPECTED_PER_UNET_CALL["fused_spatial_tail"],
             "phase 13(b): float32 attentions on the tensor-core body", tc_per_call)
    _require(frames_per_call == EXPECTED_PER_UNET_CALL["temporal_attention"]
             + 2 * EXPECTED_PER_UNET_CALL["fused_temporal_block"],
             "phase 13(b): float32 attentions on the short-sequence body", frames_per_call)

    # (b)-(d) one CFG UNet call (the request's first step): launches and bound
    # by hooks, every kernel input recorded and held, the same bits again, and
    # the call through the plain versions
    hidden = encode_prompts(pipe, ["", F32_PROMPT])
    z0 = zs[0][None].cuda()
    eps = {}

    def one_call(key):
        eps[key] = unet_pair_call(pipe.unet, z0, hidden, int(ts[0]))
    with recorded_kernel_inputs() as seen_unet:
        out["bound_per_unet_call"] = launch_bounds(pipe.unet, lambda: one_call("kernels"),
                                                   f32=True)
    bounds = out["bound_per_unet_call"]
    _require({k: bounds[k]["launches"] for k in F32_KERNELS}
             == F32_EXPECTED_PER_UNET_CALL
             and bounds["bias_epilogue_f32"]["launches"] == EPILOGUE_PER_UNET_CALL,
             "phase 13(b): one UNet call's launches", bounds)
    held, held_rows = hold_recorded(seen_unet, "unet call", tag="float32")
    out["held_per_unet_call"] = {F32_NAME.get(k, k + "_f32"): v for k, v in held.items()}
    del seen_unet
    _require(all(out["held_per_unet_call"][k]["launches"] == bounds[k]["launches"]
                 for k in F32_KERNELS),
             "phase 13(c): recorded launches differ from the hooks'", out["held_per_unet_call"])
    one_call("again")
    out["unet_call_bitwise"] = torch.equal(_bits(eps["kernels"]), _bits(eps.pop("again")))
    with swapped_kernels(lambda name, kern, plain: plain):
        one_call("plain")
    unet_dist = relative_rms(eps["kernels"], eps["plain"])
    del eps

    zf = zs[-1][0].cuda().float()[None]

    def decode_one_frame():
        with torch.inference_mode():
            return pipe.vae_decoder(zf)
    with recorded_kernel_inputs() as seen_vae:
        out["bound_vae_frame"] = launch_bounds(pipe.vae_decoder, decode_one_frame, f32=True)
    held_vae, vae_rows = hold_recorded(seen_vae, "vae frame", tag="float32")
    out["held_vae_frame"] = {F32_NAME.get(k, k + "_f32"): v for k, v in held_vae.items()}
    del seen_vae
    frame_k = decode_one_frame()
    with swapped_kernels(lambda name, kern, plain: plain):
        frame_p = decode_one_frame()
    vae_dist = relative_rms(frame_k, frame_p)
    del frame_k, frame_p
    torch.cuda.empty_cache()
    out["plain_path_relative_rms"] = dict(unet_call=unet_dist, vae_frame=vae_dist,
                                          tolerance=F32_PLAIN_RELRMS_TOL)
    with open(os.path.join(OUT_DIR, "float32_held_inputs.json"), "w") as f:
        json.dump(held_rows + vae_rows, f, indent=1)
    log(f"float32: one CFG UNet call, kernels against plain versions: relative RMS "
        f"{unet_dist:.3e}, one frame's decode {vae_dist:.3e} (tolerance "
        f"{F32_PLAIN_RELRMS_TOL}); the call again bit-identical: {out['unet_call_bitwise']}")
    _require(out["unet_call_bitwise"], "phase 13(c): the UNet call again", out)
    _require(unet_dist <= F32_PLAIN_RELRMS_TOL and vae_dist <= F32_PLAIN_RELRMS_TOL,
             "phase 13(d): the call and the decode against the plain path",
             out["plain_path_relative_rms"])

    # (e) the validator's side: 2 revealed steps bit for bit, the video bound
    # on its first and last frames, a tampered eps leaf refused, shifted by
    # 2^-4 and by 2e-4, twice the atol (the synthetic checkpoint's
    # 0.02-scaled weights leave eps near 1e-4, where phase 4's 1 + 2^-4
    # scaling stays inside the atol of 1e-4: the second shift measures the
    # refusal's margin instead of assuming it)
    leaves = {i: (int(ts[i]), zs[i], epss[i]) for c in F32_CHECKS for i in (c, c + 1)
              if i < steps}
    tol = dict(atol=1e-4, rtol=2.0 ** -7)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, _ = verify_revealed_steps(engine, F32_PROMPT, "", leaves, F32_CHECKS, steps,
                                       F32_REQUEST["guidance_scale"], same_platform=True, **tol)
    torch.cuda.synchronize()
    reexec_s = time.perf_counter() - t0
    bound, bind_err = engine.verify_video_binding(
        video, leaves[steps - 1], steps - 1, steps, F32_REQUEST["guidance_scale"], F32_PROMPT,
        frame_indices=(0, frames - 1))
    t1, z1, e1 = leaves[1]
    refused = {}
    for shift in F32_TAMPER_SHIFTS:
        tampered = {**leaves, 1: (t1, z1, (e1.float() + shift).bfloat16())}
        refused[shift] = verify_revealed_steps(
            engine, F32_PROMPT, "", tampered, [1], steps, F32_REQUEST["guidance_scale"],
            same_platform=True, **tol)[0][1]
    out["reexecution"] = dict(checks=F32_CHECKS, seconds=reexec_s,
                              passed={i: r.passed for i, r in results.items()},
                              bitwise={i: r.bitwise for i, r in results.items()},
                              binding_ok=bound, binding_err=bind_err,
                              max_abs_eps=float(epss.float().abs().max()),
                              tampered_refused={str(k): not r.passed
                                                for k, r in refused.items()},
                              tampered_reason={str(k): r.reason for k, r in refused.items()})
    log(f"float32 re-execution: steps {F32_CHECKS} in {reexec_s:.2f} s, passed "
        f"{out['reexecution']['passed']} bitwise {out['reexecution']['bitwise']}; video "
        f"binding on frames 0 and {frames - 1}: {bound} (mean |err| {bind_err:.4f}); eps leaf "
        f"shifted (max |eps| {out['reexecution']['max_abs_eps']:.3e}), refused: "
        + "; ".join(f"+{k:g}: {not r.passed} ({r.reason})" for k, r in refused.items()))
    _require(all(r.passed and r.bitwise for r in results.values()) and bound
             and not any(r.passed for r in refused.values()), "phase 13(e): re-execution",
             out["reexecution"])

    # (f) one CFG step traced: s per step and device ms by group; each float32
    # kernel's ms summed over the call beside its bound
    sched = make_ddim_schedule(steps)
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cfg_denoise_step(pipe.unet, sched, z0, 0, hidden[1:2], hidden[0:1],
                             F32_REQUEST["guidance_scale"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    out["step"] = dict(breakdown(prof, wall), seconds=wall)
    del prof
    out["kernels_per_unet_call"] = {
        k: dict(launches=bounds[k]["launches"], ms=out["held_per_unet_call"][k]["ms"],
                bound_ms=bounds[k]["bound_ms"],
                max_abs_err=out["held_per_unet_call"][k]["max_abs_err"])
        for k in F32_KERNELS}
    log(f"float32 step ({smi}): {wall:.3f} s (one batched CFG UNet call + DDIM), device busy "
        f"{out['step']['device_busy_ms']:.1f} ms, idle share {out['step']['idle_share']}, ms by "
        f"group {json.dumps(out['step']['group_ms'])}")
    for k, v in out["kernels_per_unet_call"].items():
        log(f"float32 kernel {k:26s} per UNet call: {v['launches']} launches, {v['ms']:.3f} ms "
            f"against a bound of {v['bound_ms']:.3f} ms ({v['bound_ms'] / v['ms']:.1%})")
    del pipe, engine
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"float32: phase 13 in {out['seconds']:.1f} s ({smi})")
    return out


# --- phase 9: the other families: cogvideox-5b and svd-img2vid -----------------

# cogvideox-5b's native request: 48 frames at 720x480 (latent 48 x 60 x 90 x 16,
# 30 x 45 patches a frame), CFG 6.0; the joint sequence holds 226 text tokens
# and 48 * 30 * 45 video tokens
DIT = dict(num_frames=48, height=480, width=720, guidance_scale=6.0)
DIT_TOKENS = 226 + 48 * 30 * 45          # 65,026 = 508 * 128 + 2: a ragged tail
DIT_STEPS = 3                            # of the family's 50 (about 10 s a step)
DIT_NATIVE_STEPS = 50
DIT_CHECKS = [1, 2]                      # re-executed steps; 2 is T-1 (the binding)
# the in-process round: 16 frames (S = 21,826), 3 steps
DIT_ROUND = dict(num_frames=16, height=480, width=720, num_steps=3, guidance_scale=6.0)
DIT_REDUCED_FRAMES = 4                   # the plain-path call: S = 5,626
# launches per batched DiT call: flash in each of the 42 blocks' joint attention
DIT_EXPECTED_PER_CALL = dict({k: 0 for k in MODEL_PATH}, flash_attention=42)
# flash at a DiT shape is held on query-row slices against all keys (the
# plain version over all 65,026 rows would hold 1.6 TB of logits), 16 heads
# at a time
DIT_HEAD_GROUP = 16
# svd-img2vid's request: a seeded 576x320 image, 25 frames, 25 steps, CFG 3.0
SVD = dict(num_frames=25, num_steps=25, guidance_scale=3.0)


def flash_row_slices(s: int):
    """The query rows flash is held on at sequence length s: tile 0, the
    tile holding the text / video boundary (row 226), and the last full
    128-row tile with the partial one after it."""
    last = (s // 128 - 1) * 128
    return (("tile 0", 0, 128), ("boundary tile", 128, 256), ("last tiles", last, s))


def hold_flash_rows(q, k, v, out, what: str) -> dict:
    """flash's output at a DiT shape against the plain version on
    ``flash_row_slices``' query rows, all keys, 16 heads at a time: 2 bf16
    ulps of max |plain| -> {slice: max abs error}."""
    from dvdx_tpu_torch.ops.kernels import flash_attention as fa

    errs = {}
    for label, r0, r1 in flash_row_slices(q.shape[1]):
        err = scale = 0.0
        for h0 in range(0, q.shape[2], DIT_HEAD_GROUP):
            hs = slice(h0, h0 + DIT_HEAD_GROUP)
            ref = fa.flash_attention_plain(q[:, r0:r1, hs], k[:, :, hs], v[:, :, hs])
            err = max(err, (out[:, r0:r1, hs].float() - ref.float()).abs().max().item())
            scale = max(scale, ref.float().abs().max().item())
            del ref
        tol = TOL_ULPS * 2.0 ** -7 * max(scale, 1e-6)
        errs[label] = err
        log(f"dit flash {what}: rows {r0}-{r1 - 1} of {q.shape[1]}: err={err:.3e} "
            f"tol={tol:.3e}")
        _require(np.isfinite(err) and err <= tol, f"dit flash {what} rows {r0}-{r1 - 1}",
                 dict(err=err, tol=tol))
    torch.cuda.empty_cache()
    return errs


def hold_flash_path(q, k, v, what: str) -> dict:
    """flash on the inputs a DiT path gave it: the same bits on a second
    call, and the rows of ``hold_flash_rows`` against the plain version ->
    {"shape", "max_abs_err", "ms", "slices"}."""
    from dvdx_tpu_torch.ops.kernels import flash_attention as fa

    o = fa.flash_attention(q, k, v)
    repeat = torch.equal(o.view(torch.int16), fa.flash_attention(q, k, v).view(torch.int16))
    _require(repeat, f"dit flash {what}: a second call differs", None)
    errs = hold_flash_rows(q, k, v, o, what)
    del o
    return dict(shape=list(q.shape), max_abs_err=max(errs.values()), slices=errs,
                ms=cuda_ms(lambda: fa.flash_attention(q, k, v), 3))


def check_flash_dit(path_inputs) -> dict:
    """Phase 9b: flash at the DiT's joint-attention shape (2, 65,026, 48, 64)
    against its plain version on query-row slices, on the path's own inputs
    (the first block of a re-executed DiT call) and on random ones; the same
    bits on a second call; kernel, SDPA and bound times."""
    import torch.nn.functional as F

    from dvdx_tpu_torch.ops.kernels import flash_attention as fa

    b, s, h, d = shape = (2, DIT_TOKENS, 48, 64)
    gen = torch.Generator(device="cuda").manual_seed(99)
    rand = [randn(shape, gen) for _ in range(3)]
    _require(tuple(path_inputs[0].shape) == shape, "dit flash: the path's shape",
             list(path_inputs[0].shape))
    held = {what: hold_flash_path(*qkv, what) for what, qkv in (("path inputs", path_inputs),
                                                                 ("random inputs", rand))}
    out = {"shape": list(shape), "ms": held["random inputs"]["ms"],
           "max_abs_err": max(x["max_abs_err"] for x in held.values()),
           **{what: x["slices"] for what, x in held.items()}}
    q, k, v = rand
    out["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)), 3)
    # the whole plain version would need 1.6 TB: it is timed on one query
    # tile's rows against all keys, 16 heads
    out["plain_slice_shape"] = [b, 128, DIT_HEAD_GROUP, d]
    out["plain_ms_per_slice"] = cuda_ms(lambda: fa.flash_attention_plain(
        q[:, :128, :DIT_HEAD_GROUP], k[:, :, :DIT_HEAD_GROUP], v[:, :, :DIT_HEAD_GROUP]), 2)
    out["bound_ms"], out["bound_by"] = bound_ms(*flash_cost(b, s, h, d))
    log(f"dit flash at {shape}: kernel {out['ms']:.3f} ms, SDPA {out['library_ms']:.3f} ms, "
        f"bound {out['bound_ms']:.3f} ms ({out['bound_by']}); plain version on one slice "
        f"(queries {out['plain_slice_shape']}, all {s} keys) {out['plain_ms_per_slice']:.3f} "
        f"ms; max err {out['max_abs_err']:.3e}")
    del rand, q, k, v
    torch.cuda.empty_cache()
    return out


def run_dit(smi: str) -> dict:
    """Phase 9a, 9b and 9d: cogvideox-5b at full width and depth with seeded
    random weights: one recorded request through ``StepEngine`` at 48 x
    720x480 (DIT_STEPS of 50), 2 revealed steps re-executed bit for bit,
    every frame decoded; one DiT call profiled; flash at the DiT shape held
    on row slices; one reduced-frame DiT call through the plain versions;
    an in-process round (honest and lazy miners) at 16 frames."""
    from torch.profiler import ProfilerActivity, profile

    from dvdx_tpu_torch.models.vae import decode_frames_tiled
    from dvdx_tpu_torch.network.mock import build_mock_network
    from dvdx_tpu_torch.network.validator import ValidatorConfig
    from dvdx_tpu_torch.ops import rng
    from dvdx_tpu_torch.ops.scheduler import make_ddim_schedule
    from dvdx_tpu_torch.pipelines.text2video import (build_pipeline, cfg_denoise_step,
                                                     encode_prompts)
    from dvdx_tpu_torch.utils.profile_step import breakdown
    from dvdx_tpu_torch.utils.testing import (REFERENCE_RELRMS_TOL, perturb_zero_params,
                                              relative_rms, unet_pair_call)
    from dvdx_tpu_torch.verify.merkle import MerkleCommitment
    from dvdx_tpu_torch.verify.spotcheck import StepEngine, verify_revealed_steps

    out = {"device": smi}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = perturb_zero_params(build_pipeline("cogvideox-5b", seed=0, device="cuda"), seed=99)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["params"] = {name: sum(p.numel() for p in m.parameters()) for name, m in
                     (("dit", pipe.unet), ("text", pipe.text_encoder),
                      ("vae_dec", pipe.vae_decoder))}
    log(f"dit: built cogvideox-5b (the JAX package's fast_init draws, zero leaves perturbed) "
        f"in {out['build_s']:.1f} s; params {json.dumps(out['params'])}, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    _require(out["params"]["dit"] > 7e9 and out["params"]["text"] > 3.5e9,
             "dit: parameter count", out["params"])

    # 9a: one recorded request at the native geometry, DIT_STEPS of 50 steps
    prompt = "a panda playing guitar by a campfire at night, cinematic"
    engine = StepEngine(pipe)
    reset_counts()
    timings = {}
    t0 = time.perf_counter()
    video, zs, epss, ts = engine.generate_recorded(prompt, seed=11, num_steps=DIT_STEPS,
                                                   segment_steps=DIT_STEPS, timings=timings,
                                                   **DIT)
    sec = time.perf_counter() - t0
    launches = read_counts()
    root = MerkleCommitment(ts, zs, epss).root.hex()
    out["request"] = dict(seconds=sec, steps=DIT_STEPS, steps_native=DIT_NATIVE_STEPS,
                          timings_s=timings, launches=launches, root=root,
                          peak_bytes=torch.cuda.max_memory_allocated())
    log(f"dit request: video {tuple(video.shape)} {video.dtype}, {DIT_STEPS} steps (cut "
        f"from the family's {DIT_NATIVE_STEPS}), {sec:.2f} s, peak memory "
        f"{out['request']['peak_bytes'] / 2**30:.2f} GiB, merkle root {root}; "
        f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
    _require(video.shape == (DIT["num_frames"], DIT["height"], DIT["width"], 3)
             and video.dtype == np.uint8 and float(np.std(video)) > 0
             and zs.shape == (DIT_STEPS, DIT["num_frames"], 60, 90, 16)
             and bool(torch.isfinite(zs.float()).all() and torch.isfinite(epss.float()).all()),
             "dit request: output", dict(video=list(video.shape), zs=list(zs.shape)))
    _require(launches["flash_attention"] == 42 * DIT_STEPS and launches["group_norm_act"] > 0,
             "dit request: launches (flash 42 per DiT call, GroupNorm in the decode)",
             launches)

    # one DiT call (the batched CFG step) traced: s/step, device ms per call
    hidden = encode_prompts(pipe, ["", prompt])
    sched = make_ddim_schedule(DIT_STEPS, prediction_type="v_prediction")
    z = zs[0][None].cuda()
    with torch.inference_mode():
        reset_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cfg_denoise_step(pipe.unet, sched, z, 0, hidden[1:2], hidden[0:1],
                             DIT["guidance_scale"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    per_call = read_counts()
    out["step"] = dict(breakdown(prof, wall), seconds=wall, launches_per_dit_call=per_call)
    del prof
    step = out["step"]
    log(f"dit step (one batched CFG DiT call + DDIM): {wall:.3f} s, device busy "
        f"{step['device_busy_ms']:.1f} ms, idle share {step['idle_share']}, ms by group "
        f"{json.dumps(step['group_ms'])}; launches per DiT call "
        f"{json.dumps({k: v for k, v in per_call.items() if v})}")
    _require({k: per_call[k] for k in MODEL_PATH} == DIT_EXPECTED_PER_CALL,
             "dit: launches per DiT call", per_call)

    # the validator's side: 2 revealed steps (T-1 among them) bit for bit, the
    # video bound on its first and last frames; the first block's flash
    # inputs kept for 9b
    leaves = {i: (int(ts[i]), zs[i], epss[i]) for c in DIT_CHECKS for i in (c, c + 1)
              if i < DIT_STEPS}
    t0 = time.perf_counter()
    with recorded_kernel_inputs() as seen:
        results, _ = verify_revealed_steps(engine, prompt, "", leaves, DIT_CHECKS, DIT_STEPS,
                                           DIT["guidance_scale"], same_platform=True,
                                           atol=1e-4, rtol=2.0 ** -7)
    torch.cuda.synchronize()
    reexec_s = time.perf_counter() - t0
    bound, bind_err = engine.verify_video_binding(
        video, leaves[DIT_STEPS - 1], DIT_STEPS - 1, DIT_STEPS, DIT["guidance_scale"], prompt,
        frame_indices=(0, DIT["num_frames"] - 1))
    base = torch.equal(engine.base_latent(11, DIT["num_frames"], DIT["height"],
                                          DIT["width"]).view(torch.int16),
                       zs[0].view(torch.int16))
    out["reexecution"] = dict(checks=DIT_CHECKS, seconds=reexec_s,
                              passed={i: r.passed for i, r in results.items()},
                              bitwise={i: r.bitwise for i, r in results.items()},
                              binding_ok=bound, binding_err=bind_err, base_latent_bitwise=base)
    log(f"dit re-execution: steps {DIT_CHECKS} in {reexec_s:.2f} s, passed "
        f"{out['reexecution']['passed']} bitwise {out['reexecution']['bitwise']}; base "
        f"latent bitwise {base}; video binding on frames 0 and {DIT['num_frames'] - 1}: "
        f"{bound} (mean |err| {bind_err:.4f})")
    _require(all(r.passed and r.bitwise for r in results.values()) and bound and base,
             "dit: re-execution", out["reexecution"])
    (_count, args, _kw), = seen["flash_attention"].values()
    path_qkv = args[:3]
    del seen, args

    # one frame's decode as the request makes it (decode_frames_tiled, one
    # frame a call): its kernel inputs held against the plain versions
    with torch.inference_mode(), recorded_kernel_inputs() as seen_frame:
        decode_frames_tiled(pipe.vae_decoder, zs[-1][:1].cuda().float())
    out["held_vae_frame"], frame_rows = hold_recorded(seen_frame, "vae frame", tag="dit")
    held_sigs = {name: set(calls) for name, calls in seen_frame.items()}
    del seen_frame
    gn_frame = out["held_vae_frame"].get("group_norm_act", {}).get("launches", 0)

    def decode_frame():
        with torch.inference_mode():
            decode_frames_tiled(pipe.vae_decoder, zs[-1][:1].cuda().float())
    # each kernel's bound summed over that frame's launches, from their shapes
    out["bound_vae_frame"] = launch_bounds(pipe.vae_decoder, decode_frame)
    log(f"dit: bound per frame's VAE decode {json.dumps(out['bound_vae_frame'])}")
    _require(gn_frame > 0 and gn_frame * DIT["num_frames"] == launches["group_norm_act"],
             "dit: one frame's decode launches GroupNorm as the request did, per frame",
             dict(frame=gn_frame, request=launches["group_norm_act"]))

    # 9b: flash at the DiT shape, then one reduced-frame DiT call through the
    # kernels and through the plain versions
    out["flash"] = check_flash_dit(path_qkv)
    del path_qkv
    z4 = rng.video_noise(rng.base_key(5), DIT_REDUCED_FRAMES, (60, 90, 16),
                         device="cuda")[None].bfloat16()
    t = int(sched.timesteps[0])
    reset_counts()
    with recorded_kernel_inputs() as seen_reduced:
        eps_k = unet_pair_call(pipe.unet, z4, hidden, t)
    flash_reduced = read_counts()["flash_attention"]
    with swapped_kernels(lambda name, kern, plain: plain):
        eps_p = unet_pair_call(pipe.unet, z4, hidden, t)
    dist = relative_rms(eps_k, eps_p)
    (_count, args, _kw), = seen_reduced["flash_attention"].values()
    out["reduced_call"] = dict(frames=DIT_REDUCED_FRAMES, tokens=226 + DIT_REDUCED_FRAMES * 1350,
                               relative_rms=dist, flash_launches=flash_reduced,
                               max_abs_eps=eps_k.abs().max().item(),
                               flash=hold_flash_path(*args[:3], "reduced call"))
    del eps_k, eps_p, seen_reduced, args
    torch.cuda.empty_cache()
    log(f"dit: one {DIT_REDUCED_FRAMES}-frame DiT call (S = {226 + DIT_REDUCED_FRAMES * 1350}),"
        f" kernels against plain versions on the card: relative RMS {dist:.5f} (tolerance "
        f"{REFERENCE_RELRMS_TOL}); flash launches {flash_reduced}")
    _require(dist <= REFERENCE_RELRMS_TOL and flash_reduced == 42,
             "dit: reduced call against the plain path", out["reduced_call"])

    # 9d: an in-process round at 16 frames: an honest miner passes bit for
    # bit, a lazy one is caught at its check
    cfg = ValidatorConfig(sample_size=2, num_checkpoints=2, ping_timeout_s=30,
                          timeout_s=900, results_dir=os.path.join(OUT_DIR, "network"),
                          **DIT_ROUND)
    net = build_mock_network(n_miners=2, adversaries=["honest", "lazy"], pipeline=pipe,
                             validator_config=cfg)
    with recorded_kernel_inputs() as seen_round:
        report, wall, counts = _run_round(net, "round-cogvideox", prompt)
    line = _round_line(report, wall)
    line["launches"] = {k: v for k, v in counts.items() if v}
    out["round"] = line
    # the round's kernel inputs: flash (S = 21,826) on row slices; any other
    # input the frame's decode did not give, against the plain version
    out["round_flash"] = [hold_flash_path(*args[:3], "round")
                          for _count, args, _kw in seen_round.pop("flash_attention").values()]
    rest = {name: {sig: e for sig, e in calls.items() if sig not in held_sigs.get(name, ())}
            for name, calls in seen_round.items()}
    rest = {name: calls for name, calls in rest.items() if calls}
    out["held_round"], round_rows = hold_recorded(rest, "round", tag="dit") if rest else ({}, [])
    del seen_round, rest
    with open(os.path.join(OUT_DIR, "cogvideox_held_inputs.json"), "w") as f:
        json.dump(frame_rows + round_rows, f, indent=1)
    log(f"dit round ({DIT_ROUND['num_frames']} frames, {DIT_ROUND['num_steps']} steps): "
        f"{json.dumps(line)}")
    honest, lazy = report["miners"]["0"], report["miners"]["1"]
    _require(not honest.get("failed_check") and not honest.get("cheat")
             and all(honest["checks"].values()) and honest["same_platform"] is True
             and honest["reexec_bitwise"] is True and honest["score"] > 0,
             "dit round: the honest miner", honest)
    _require(lazy.get("failed_check") == "reexecution" and lazy.get("cheat") is True,
             "dit round: the lazy miner", lazy)
    _require(counts["flash_attention"] > 0, "dit round: flash never launched", counts)
    del net, pipe, engine, hidden, z, z4
    torch.cuda.empty_cache()
    return out


def run_svd(smi: str) -> dict:
    """Phase 9c: svd-img2vid at full width with seeded random weights: a
    full request from a seeded 576x320 image (25 frames, 25 steps, CFG 3.0,
    recorded) twice, bit for bit; every distinct kernel input of one
    batched UNet call (the 1-token context, 25 frames) and of one VAE encode
    held against the plain versions; that call through the plain versions."""
    from dvdx_tpu_torch.ops import rng
    from dvdx_tpu_torch.ops.scheduler import make_ddim_schedule
    from dvdx_tpu_torch.pipelines.img2video import (build_img2video_pipeline, conditioning,
                                                    generate_from_image)
    from dvdx_tpu_torch.utils.testing import (REFERENCE_RELRMS_TOL, perturb_zero_params,
                                              relative_rms, unet_pair_call)
    from dvdx_tpu_torch.verify.merkle import MerkleCommitment

    out = {"device": smi}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pipe = perturb_zero_params(build_img2video_pipeline("svd-img2vid", seed=0, device="cuda"),
                               seed=99)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["params"] = {name: sum(p.numel() for p in m.parameters()) for name, m in
                     (("unet", pipe.base.unet), ("text", pipe.base.text_encoder),
                      ("vae_dec", pipe.base.vae_decoder), ("vae_enc", pipe.vae_encoder))}
    image = np.random.default_rng(21).integers(0, 256, (320, 576, 3), dtype=np.uint8)
    runs = []
    for rep in range(2):
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        video, (zs, epss, ts) = generate_from_image(pipe, image, seed=13, record=True, **SVD)
        torch.cuda.synchronize()
        runs.append((video, zs, epss, MerkleCommitment(ts, zs, epss).root.hex(),
                     time.perf_counter() - t0, read_counts(), torch.cuda.max_memory_allocated()))
    (v1, z1, e1, r1, s1, launches, peak), (v2, z2, e2, r2, s2, _, _) = runs
    same = (torch.equal(z1.view(torch.int16), z2.view(torch.int16))
            and torch.equal(e1.view(torch.int16), e2.view(torch.int16))
            and np.array_equal(v1, v2) and r1 == r2)
    out["request"] = dict(seconds=[s1, s2], root=r1, bitwise=same, launches=launches,
                          peak_bytes=peak)
    log(f"svd request: built in {out['build_s']:.1f} s, params {json.dumps(out['params'])}; "
        f"video {tuple(v1.shape)} {v1.dtype}, {SVD['num_steps']} steps twice ({s1:.2f} s, "
        f"{s2:.2f} s), peak memory {peak / 2**30:.2f} GiB, roots {r1} / {r2}, "
        f"bit-identical={same}; launches {json.dumps(launches)}")
    _require(v1.shape == (SVD["num_frames"], 320, 576, 3) and v1.dtype == np.uint8
             and float(np.std(v1)) > 0 and z1.shape == (SVD["num_steps"], 1, 25, 40, 72, 4)
             and bool(torch.isfinite(z1.float()).all() and torch.isfinite(e1.float()).all()),
             "svd request: output", dict(video=list(v1.shape), zs=list(z1.shape)))
    _require(same, "svd request: the repeat is not bit-identical", [r1, r2])
    missing = [k for k in MODEL_PATH if launches[k] == 0]
    _require(not missing, "svd request: kernels never launched", missing)

    # one batched UNet call at the first step, and one VAE encode, their
    # kernel inputs recorded where the layers call them
    key = rng.base_key(13)
    img = torch.from_numpy(image).cuda().float() / 127.5 - 1.0
    with torch.inference_mode():
        cond_lat, ctx, uncond = conditioning(pipe, img, key, 0.02)
    hidden = torch.cat([uncond, ctx])
    x = torch.cat([z1[0].cuda(), cond_lat.bfloat16().expand(z1.shape[1:])], dim=-1)
    t = int(make_ddim_schedule(SVD["num_steps"]).timesteps[0])
    eps = {}
    reset_counts()
    with recorded_kernel_inputs() as seen_unet:
        out["bound_per_unet_call"] = launch_bounds(
            pipe.base.unet, lambda: eps.update(k=unet_pair_call(pipe.base.unet, x, hidden, t)))
    per_call, eps_k = read_counts(), eps.pop("k")
    with swapped_kernels(lambda name, kern, plain: plain):
        eps_p = unet_pair_call(pipe.base.unet, x, hidden, t)
    dist = relative_rms(eps_k, eps_p)
    with torch.inference_mode(), recorded_kernel_inputs() as seen_enc:
        pipe.vae_encoder(img[None])
    out["launches_per_unet_call"] = {k: per_call[k] for k in MODEL_PATH}
    out["plain_path_relative_rms"] = dist
    out["held_per_unet_call"], rows_unet = hold_recorded(seen_unet, "unet call", tag="svd")
    out["held_vae_encode"], rows_enc = hold_recorded(seen_enc, "vae encode", tag="svd")
    with open(os.path.join(OUT_DIR, "svd_held_inputs.json"), "w") as f:
        json.dump(rows_unet + rows_enc, f, indent=1)
    out["shapes"] = {}
    for row in rows_unet + rows_enc:
        out["shapes"].setdefault(row["kernel"], []).append(row["shapes"][0])
    log(f"svd: bound per UNet call {json.dumps(out['bound_per_unet_call'])}")
    log(f"svd: launches per UNet call {json.dumps(out['launches_per_unet_call'])}; one UNet "
        f"call, kernels against plain versions on the card: relative RMS {dist:.5f} "
        f"(tolerance {REFERENCE_RELRMS_TOL})")
    _require(out["launches_per_unet_call"] == EXPECTED_PER_UNET_CALL,
             "svd: launches per UNet call", out["launches_per_unet_call"])
    _require(dist <= REFERENCE_RELRMS_TOL, "svd: UNet call against the plain path", dist)
    _require(out["held_vae_encode"].get("group_norm_act", {}).get("launches", 0) > 0,
             "svd: the VAE encode's GroupNorms", out["held_vae_encode"])
    del pipe, seen_unet, seen_enc, eps_k, eps_p
    torch.cuda.empty_cache()
    return out


def run_families(smi: str) -> dict:
    """Phase 9: cogvideox-5b, then svd-img2vid."""
    t0 = time.perf_counter()
    out = {"dit": run_dit(smi)}
    out["dit_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["svd"] = run_svd(smi)
    out["svd_seconds"] = time.perf_counter() - t0
    log(f"families: cogvideox-5b phase {out['dit_seconds']:.1f} s, svd-img2vid phase "
        f"{out['svd_seconds']:.1f} s")
    with open(os.path.join(OUT_DIR, "families.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    return out


# --- phase 14: the published CogVideoX-5B (cogvideox-5b-hf) ------------------

def hold_cog_hf_kernels(seen) -> tuple:
    """Each recorded call of the block's three kernels against its plain
    version (``_one_rounding``; each in-place call on a copy) and against
    itself (the same bits on a second call), on the inputs the path gave it
    and on random inputs of the same shapes and strides; its device time on
    the path's inputs beside its bytes bound -> ({kernel: {"shapes",
    "launches", "ms", "bound_ms", "roofline_pct", "max_abs_err",
    "min_same_bits"}}, rows)."""
    sites = cog_hf_kernel_sites()
    gen = torch.Generator(device="cuda").manual_seed(4321)
    summary, rows = {}, []
    with torch.inference_mode():
        for name, calls in seen.items():
            mod, attr, plain = sites[name]
            kern = getattr(mod, attr)
            s = summary.setdefault(name, dict(shapes=0, launches=0, ms=0.0, bound_ms=0.0,
                                              max_abs_err=0.0, min_same_bits=1.0))
            for count, args, kwargs in calls.values():
                shapes = [list(a.shape) for a in args if isinstance(a, torch.Tensor)]
                row = dict(kernel=name, shapes=shapes, calls=count)
                for inputs, (a, kw) in (("path", (args, kwargs)),
                                        ("random", _random_like((args, kwargs), gen))):
                    out = kern(*_fresh(name, a), **kw)
                    again = kern(*_fresh(name, a), **kw)
                    ref = plain(*_fresh(name, a), **kw)
                    out, again, ref = ((x,) if isinstance(x, torch.Tensor) else x
                                       for x in (out, again, ref))
                    close = [_one_rounding(o, r) for o, r in zip(out, ref)]
                    repeat = all(torch.equal(_bits(o), _bits(x)) for o, x in zip(out, again))
                    del out, again, ref
                    err = max(c["max_abs_err"] for c in close)
                    same = min(c["same_bits"] for c in close)
                    over = sum(c["over_tol"] for c in close)
                    row.update({f"{inputs}_max_abs_err": err, f"{inputs}_over_tol": over,
                                f"{inputs}_same_bits": same, f"{inputs}_repeat_bitwise": repeat})
                    log(f"cogvideox-hf: {name} at {shapes} on {inputs} inputs: max err "
                        f"{err:.3e}, {over} outputs over one rounding step, same bits "
                        f"{same:.6f}, repeat bitwise {repeat}")
                    _require(np.isfinite(err) and over == 0 and same >= COG_HF_SAME_BITS
                             and repeat, f"cogvideox-hf: {name} at {shapes} on {inputs} "
                             f"inputs against its plain version and itself", row)
                    s["max_abs_err"] = max(s["max_abs_err"], err)
                    s["min_same_bits"] = min(s["min_same_bits"], same)
                fresh = _fresh(name, args)
                row["ms"] = cuda_ms(lambda: kern(*fresh, **kwargs), 5)
                row["bound_ms"], row["bound_by"] = bound_ms(*cog_hf_cost(name, args),
                                                            PEAK_F32_FLOPS)
                row["roofline_pct"] = 100.0 * row["bound_ms"] / row["ms"]
                del fresh
                rows.append(row)
                s["shapes"] += 1
                s["launches"] += count
                s["ms"] += count * row["ms"]
                s["bound_ms"] += count * row["bound_ms"]
            s["roofline_pct"] = 100.0 * s["bound_ms"] / s["ms"]
    torch.cuda.empty_cache()
    return summary, rows


def seeded_on_card(module: torch.nn.Module, seed: int) -> None:
    """Every parameter drawn on the card from ``seed`` as a checkpoint's
    would be spread: a matrix or kernel N(0, 1 / fan_in), a norm's scale
    1 + N(0, 0.05^2), a shift or bias N(0, 0.05^2)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() >= 2:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
            else:
                p.normal_(1.0 if name.endswith("weight") else 0.0, 0.05, generator=gen)


def run_cogvideox_hf(smi: str) -> dict:
    """Phase 14: cogvideox-5b-hf at full width and depth, bf16, weights
    drawn on the card: a recorded request at the geometry of its benchmark
    configuration (13 x 480x720, COG_HF_STEPS steps, every frame decoded),
    the launches per DiT call of one CFG step read with the counters set to
    0 just before it (``COG_HF_PER_DIT_CALL``, nothing else launched); the
    inputs of a second step's kernels recorded where the layers call them
    and held against the plain versions: the block's three kernels
    (``hold_cog_hf_kernels``), the bias epilogue bit for bit
    (``hold_recorded``) and flash on query-row slices (``hold_flash_path``),
    each also on random inputs of the same shapes."""
    from dvdx_tpu_torch.models.zoo import get_model_spec
    from dvdx_tpu_torch.pipelines.text2video import (cfg_denoise_step, empty_pipeline,
                                                     encode_prompts)
    from dvdx_tpu_torch.verify.spotcheck import StepEngine

    out = {"device": smi}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    spec = get_model_spec(COG_HF_MODEL)
    pipe = empty_pipeline(spec, "cuda")
    for i, module in enumerate((pipe.unet, pipe.text_encoder, pipe.vae_decoder)):
        seeded_on_card(module, 21 + i)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["params"] = {name: sum(p.numel() for p in m.parameters()) for name, m in
                     (("dit", pipe.unet), ("text", pipe.text_encoder),
                      ("vae_dec", pipe.vae_decoder))}
    log(f"cogvideox-hf: built {COG_HF_MODEL} in {out['build_s']:.1f} s; params "
        f"{json.dumps(out['params'])}, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    _require(out["params"]["dit"] == 5_570_283_072, "cogvideox-hf: transformer parameters",
             out["params"])

    # a recorded request, as a miner serves it
    prompt = "a panda playing guitar by a campfire at night, cinematic"
    engine = StepEngine(pipe)
    reset_counts()
    timings = {}
    t0 = time.perf_counter()
    video, zs, epss, ts = engine.generate_recorded(prompt, seed=11, num_steps=COG_HF_STEPS,
                                                   segment_steps=COG_HF_STEPS,
                                                   timings=timings, **COG_HF)
    sec = time.perf_counter() - t0
    launches = read_counts()
    out["request"] = dict(seconds=sec, steps=COG_HF_STEPS, timings_s=timings,
                          launches=launches, peak_bytes=torch.cuda.max_memory_allocated())
    log(f"cogvideox-hf request: video {tuple(video.shape)}, {COG_HF_STEPS} steps, {sec:.2f} s, "
        f"peak memory {out['request']['peak_bytes'] / 2**30:.2f} GiB; launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    _require(video.shape == (COG_HF["num_frames"], COG_HF["height"], COG_HF["width"], 3)
             and float(np.std(video)) > 0
             and zs.shape == (COG_HF_STEPS, COG_HF["num_frames"], 60, 90, 16)
             and bool(torch.isfinite(zs.float()).all() and torch.isfinite(epss.float()).all()),
             "cogvideox-hf request: output", dict(video=list(video.shape), zs=list(zs.shape)))
    for k in COG_HF_PATH + ("flash_attention",):
        _require(launches[k] == COG_HF_STEPS * COG_HF_PER_DIT_CALL[k],
                 f"cogvideox-hf request: {k} launches per DiT call", launches)

    # one CFG step through the pipeline's step, the counters set to 0 just
    # before it
    hidden = encode_prompts(pipe, ["", prompt])
    sched = spec.ddim_schedule(50)
    z = zs[0][None].cuda()
    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        cfg_denoise_step(pipe.unet, sched, z, 0, hidden[1:2], hidden[0:1],
                         COG_HF["guidance_scale"])
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    per_call = read_counts()
    out["step"] = dict(seconds=step_s, launches_per_dit_call=per_call)
    log(f"cogvideox-hf step (one batch-2 CFG DiT call + DDIM, {COG_HF_TOKENS} joint tokens): "
        f"{step_s:.3f} s; launches per DiT call "
        f"{json.dumps({k: v for k, v in per_call.items() if v})}")
    _require(per_call == dict({k: 0 for k in per_call}, **COG_HF_PER_DIT_CALL),
             "cogvideox-hf: launches per DiT call", dict(per_call=per_call,
                                                          expected=COG_HF_PER_DIT_CALL))

    # the same step's kernel inputs, recorded where the layers call them
    path = path_kernel_sites()
    sites = dict(cog_hf_kernel_sites(), flash_attention=path["flash_attention"],
                 bias_epilogue=path["bias_epilogue"])
    with torch.inference_mode(), recorded_kernel_inputs(sites) as seen:
        cfg_denoise_step(pipe.unet, sched, z, 0, hidden[1:2], hidden[0:1],
                         COG_HF["guidance_scale"])
    torch.cuda.synchronize()
    del pipe, engine, video, zs, epss, ts, hidden, z
    torch.cuda.empty_cache()
    (_count, args, _kw), = seen.pop("flash_attention").values()
    b, s, h, d = args[0].shape
    _require((b, s, h, d) == (2, COG_HF_TOKENS, 48, 64), "cogvideox-hf: flash's shape",
             list(args[0].shape))
    gen = torch.Generator(device="cuda").manual_seed(99)
    flash = {what: hold_flash_path(*qkv, f"cogvideox-hf {what}") for what, qkv in (
        ("path inputs", args[:3]), ("random inputs", [randn((b, s, h, d), gen)
                                                      for _ in range(3)]))}
    fb_ms, fb_by = bound_ms(*flash_cost(b, s, h, d))
    out["flash"] = dict(shape=[b, s, h, d], ms=flash["path inputs"]["ms"], bound_ms=fb_ms,
                        bound_by=fb_by, roofline_pct=100.0 * fb_ms / flash["path inputs"]["ms"],
                        max_abs_err=max(x["max_abs_err"] for x in flash.values()),
                        **{what: x["slices"] for what, x in flash.items()})
    del args, flash
    torch.cuda.empty_cache()
    out["bias_epilogue"], epi_rows = hold_recorded({"bias_epilogue": seen.pop("bias_epilogue")},
                                                   "one DiT call", tag="cogvideox-hf")
    out["block_kernels"], rows = hold_cog_hf_kernels(seen)
    del seen
    torch.cuda.empty_cache()
    with open(os.path.join(OUT_DIR, "cogvideox_hf.json"), "w") as f:
        json.dump(dict(out, rows=rows + epi_rows), f, indent=1, default=str)
    log(f"cogvideox-hf ({smi}): flash at {out['flash']['shape']} {out['flash']['ms']:.3f} ms, "
        f"{out['flash']['roofline_pct']:.1f}% of its bound; block kernels per DiT call "
        + json.dumps({k: {f: round(v[f], 4) for f in ("launches", "ms", "bound_ms",
                                                      "roofline_pct", "min_same_bits")}
                      for k, v in out["block_kernels"].items()}))
    return out


# --- phase 10: the distribution pillar ---------------------------------------

STRAT_PROMPT = "a red panda rides a bicycle through a snowy forest"  # Request A's
STRAT_SEED = 7
STRAT_GEOMETRY = dict(num_frames=16, height=320, width=576, num_steps=25,
                      guidance_scale=7.5)
NCCL_STEPS = 3


def _strategy_run(pipe, name, mesh, steps=25, **overrides):
    """One video through ``build_runner``: its uint8 frames, s/video, peak
    memory, kernel launches, chunk plan and the FSDP hooks' all-gathers."""
    from dvdx_tpu_torch.ops import rng
    from dvdx_tpu_torch.parallel.strategies import build_runner, get_strategy
    from dvdx_tpu_torch.pipelines.text2video import to_uint8

    runner = build_runner(pipe, get_strategy(name, **overrides), mesh,
                          **dict(STRAT_GEOMETRY, num_steps=steps))
    ids = torch.from_numpy(pipe.tokenize(["", STRAT_PROMPT])).long()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    frames = runner(ids, rng.base_key(STRAT_SEED))
    torch.cuda.synchronize()
    out = dict(seconds=time.perf_counter() - t0, peak_bytes=torch.cuda.max_memory_allocated(),
               launches=read_counts(), plan=runner.plan, frames=frames,
               video=to_uint8(frames).cpu().numpy(),
               gathers=sum(s.gathers for s in runner.shards))
    runner.close()
    return out


def _chunked_unet_call(pipe):
    """One batched CFG UNet call of the chunked program at Request A's
    geometry: 2 chunks of 9 frames, [uncond x 2, cond x 2] -> batch 4."""
    from dvdx_tpu_torch.ops import rng
    from dvdx_tpu_torch.ops.scheduler import make_ddim_schedule
    from dvdx_tpu_torch.parallel.chunking import auto_chunk_count, gather_chunks, plan_chunks
    from dvdx_tpu_torch.pipelines.text2video import encode_prompts

    plan = plan_chunks(16, auto_chunk_count(16, 1))
    z0 = rng.video_noise(rng.base_key(STRAT_SEED), 16, (40, 72, 4), device="cuda")
    rows = gather_chunks(z0[None].bfloat16(), plan)[0]  # (2, 9, 40, 72, 4)
    n = rows.shape[0]
    hidden = encode_prompts(pipe, ["", STRAT_PROMPT])
    ctx = torch.cat([hidden[0:1].repeat_interleave(n, 0), hidden[1:2].repeat_interleave(n, 0)])
    t = int(make_ddim_schedule(25).timesteps[0])
    ts = torch.full((2 * n,), t, dtype=torch.int32, device="cuda")

    def call():
        with torch.inference_mode():
            return pipe.unet(torch.cat([rows, rows]), ts, ctx)
    return call


def _text_and_noise(pipe):
    """Request A's (uncond, cond) text states and its base noise on the card."""
    from dvdx_tpu_torch.ops import rng
    from dvdx_tpu_torch.pipelines.text2video import encode_prompts

    hidden = encode_prompts(pipe, ["", STRAT_PROMPT])
    z0 = rng.video_noise(rng.base_key(STRAT_SEED), 16, (40, 72, 4), device="cuda")
    return hidden[0:1], hidden[1:2], z0


def _routed_at_one_rank(pipe, mesh, steps: int):
    """The exact-CP program at a seq axis of 1: ``steps`` denoise steps
    inside ``ring_context`` per algo (ring, auto), against the same steps
    outside it. Counts the routed pieces the layers call (attention with
    impl='ring', the conv halo, the frame-sharded GroupNorm) and the kernel
    launches, and keeps the first frame-axis attention input."""
    import dvdx_tpu_torch.models.layers as layers
    from dvdx_tpu_torch.ops.attention import ring_context
    from dvdx_tpu_torch.ops.scheduler import make_ddim_schedule
    from dvdx_tpu_torch.pipelines.text2video import denoise
    from dvdx_tpu_torch.utils.testing import REFERENCE_RELRMS_TOL, relative_rms

    uncond, cond, z0 = _text_and_noise(pipe)
    sched = make_ddim_schedule(25)
    z0 = z0[None].bfloat16()
    with torch.inference_mode():
        ref = denoise(pipe.unet, sched, z0, cond, uncond, 7.5, step_range=(0, steps)).float()
    saved = {k: getattr(layers, k) for k in ("multi_head_attention", "frame_halo",
                                             "group_norm_act_sharded")}
    out, first, latents = {}, {}, {}
    for algo in ("ring", "auto"):
        calls = dict.fromkeys(saved, 0)

        def counted(name):
            def fn(*a, **kw):
                if name != "multi_head_attention" or kw.get("impl") == "ring":
                    calls[name] += 1
                    if name == "multi_head_attention" and "qkv" not in first:
                        first["qkv"] = tuple(t.clone() for t in a[:3])
                return saved[name](*a, **kw)
            return fn

        for k in saved:
            setattr(layers, k, counted(k))
        try:
            reset_counts()
            t0 = time.perf_counter()
            with torch.inference_mode(), ring_context(mesh, "seq", algo=algo):
                z = denoise(pipe.unet, sched, z0, cond, uncond, 7.5,
                            frame_positions=torch.arange(16, device="cuda"),
                            step_range=(0, steps)).float()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        finally:
            for k, v in saved.items():
                setattr(layers, k, v)
        launches = read_counts()
        dist_ = relative_rms(z, ref)
        latents[algo] = z
        out[algo] = {"relative_rms_vs_single": dist_, "seconds": sec,
                     "ring_impl_attention_calls": calls["multi_head_attention"],
                     "frame_halo_calls": calls["frame_halo"],
                     "sharded_group_norm_calls": calls["group_norm_act_sharded"],
                     "launches": {k: launches[k] for k in MODEL_PATH}}
        off = [k for k in ("fused_spatial_tail", "fused_temporal_block",
                           "temporal_attention") if launches[k]]
        on = [k for k in ("flash_attention", "geglu_ff", "group_norm_act") if not launches[k]]
        _require(torch.isfinite(z).all().item() and dist_ <= REFERENCE_RELRMS_TOL
                 and not off and not on and all(calls.values()),
                 f"strategies: the exact-CP program at one rank ({algo})",
                 dict(out[algo], kernels_not_off=off, kernels_not_on=on))
    # ROADMAP §3.5: the same program with the fused gates off and no route
    # taken (no ring context), so its distance from single is the unfused
    # path's bf16 rounding alone
    reset_counts()
    t0 = time.perf_counter()
    saved_active = layers.ring_active
    layers.ring_active = lambda: True
    try:
        with torch.inference_mode():
            z = denoise(pipe.unet, sched, z0, cond, uncond, 7.5,
                        frame_positions=torch.arange(16, device="cuda"),
                        step_range=(0, steps)).float()
        torch.cuda.synchronize()
    finally:
        layers.ring_active = saved_active
    launches = read_counts()
    off = [k for k in ("fused_spatial_tail", "fused_temporal_block", "temporal_attention")
           if launches[k]]
    out["fused_off_unrouted"] = {
        "relative_rms_vs_single": relative_rms(z, ref),
        "relative_rms_vs_routed_ring": relative_rms(z, latents["ring"]),
        "bit_equal_to_routed_ring": torch.equal(z, latents["ring"]),
        "seconds": time.perf_counter() - t0,
        "launches": {k: launches[k] for k in MODEL_PATH}}
    _require(torch.isfinite(z).all().item() and not off,
             "strategies: the fused-off, unrouted program", out["fused_off_unrouted"])
    return out, first["qkv"]


def _hold_ring_at_one_rank(q, k, v, mesh) -> dict:
    """ring_attention and ulysses_attention on the card at the routed
    frame-axis input, against the plain attention (the ring within 2 bf16
    ulps of max|plain|: it rounds unnormalised probabilities; Ulysses, whose
    all-to-alls are one-rank identities here, bit for bit)."""
    from dvdx_tpu_torch.ops.kernels.flash_attention import flash_attention_plain
    from dvdx_tpu_torch.ops.ring_attention import ring_attention, ulysses_attention

    with torch.inference_mode():
        ref = flash_attention_plain(q, k, v)
        ring = ring_attention(q, k, v, mesh)
        uly = ulysses_attention(q, k, v, mesh)
    err = (ring.float() - ref.float()).abs().max().item()
    tol = TOL_ULPS * 2.0 ** -7 * ref.float().abs().max().item()
    row = {"shape": list(q.shape), "ring_max_abs_err": err, "ring_tol": tol,
           "ulysses_bitwise": torch.equal(uly, ref),
           "ring_ms": cuda_ms(lambda: ring_attention(q, k, v, mesh), 3),
           "ulysses_ms": cuda_ms(lambda: ulysses_attention(q, k, v, mesh), 3),
           "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v), 3)}
    _require(np.isfinite(err) and err <= tol and row["ulysses_bitwise"],
             "strategies: ring / Ulysses attention on the card", row)
    return row


def _mesh_miner_memory(pipe, mesh, runner_peak: int) -> dict:
    """An fsdp ``Miner`` on the group: the bytes its construction allocates
    (the engine shards the pipeline in place, so no second copy of the
    weights), and the peak of a 3-step recorded generation beside the fsdp
    runner's."""
    from dvdx_tpu_torch.network.base import Registry
    from dvdx_tpu_torch.network.miner import Miner
    from dvdx_tpu_torch.verify.proof import Keypair

    weights = sum(p.numel() * p.element_size() for p in pipe.parameters())
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    miner = Miner(pipe, Keypair.from_seed(b"mesh-miner"), Registry(), mesh=mesh,
                  strategy="fsdp")
    torch.cuda.synchronize()
    built, build_peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        miner.engine.generate_recorded(STRAT_PROMPT, seed=STRAT_SEED,
                                       **dict(STRAT_GEOMETRY, num_steps=NCCL_STEPS))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    finally:
        miner.engine.close()
    torch.cuda.synchronize()
    closed = torch.cuda.memory_allocated()
    row = {"tag": miner.platform_tag, "weights_gib": weights / 2**30,
           "construct_added_gib": (built - before) / 2**30,
           "construct_peak_added_gib": (build_peak - before) / 2**30,
           "generate_peak_gib": peak / 2**30, "runner_peak_gib": runner_peak / 2**30,
           "after_close_added_gib": (closed - before) / 2**30}
    _require(build_peak - before < 0.5 * weights and abs(closed - before) < 0.05 * weights
             and miner.platform_tag == "torch-cuda:fsdp",
             "strategies: the mesh miner shards in place and gives the weights back", row)
    return row


def _per_chunk_reference(pipe, steps: int = 25):
    """The chunk program one chunk per UNet batch (the coordinator's
    workers' CFG pair): (stitched float32 latent, uint8 video)."""
    from dvdx_tpu_torch.ops.scheduler import make_ddim_schedule
    from dvdx_tpu_torch.parallel.chunking import blend_chunks, gather_chunks, plan_chunks
    from dvdx_tpu_torch.parallel.mesh import single_device_mesh
    from dvdx_tpu_torch.parallel.strategies import decode_latents
    from dvdx_tpu_torch.pipelines.text2video import denoise, to_uint8

    uncond, cond, z0 = _text_and_noise(pipe)
    plan = plan_chunks(16, 2)
    rows = gather_chunks(z0[None].bfloat16(), plan)[0]
    sched = make_ddim_schedule(steps)
    with torch.inference_mode():
        zs = [denoise(pipe.unet, sched, rows[i:i + 1], cond, uncond, 7.5)
              for i in range(plan.num_chunks)]
        z = blend_chunks(torch.cat(zs)[None].float(), plan)[0]
        video = to_uint8(decode_latents(pipe, z, single_device_mesh("cuda")))
    return z.cpu().numpy(), video.cpu().numpy()


def _strategy_cli(args, timeout):
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "dvdx_tpu_torch", *args],
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"python -m dvdx_tpu_torch {' '.join(args)} exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    return proc, time.perf_counter() - t0


def run_strategies(pipe, request_a_sha: str) -> dict:
    """Phase 10: the distribution strategies on Request A's model."""
    import csv

    import torch.distributed as dist

    from dvdx_tpu_torch.network.mock import build_mock_network
    from dvdx_tpu_torch.network.validator import ValidatorConfig
    from dvdx_tpu_torch.parallel.latent_chunking import chunk_bounds
    from dvdx_tpu_torch.parallel.mesh import (free_port, init_process_group, make_mesh,
                                              single_device_mesh)
    from dvdx_tpu_torch.scoring.temporal import (boundary_pairs, flow_warp_error,
                                                 temporal_instability)

    t_phase = time.perf_counter()
    out = {"runs": {}}
    one = single_device_mesh("cuda")
    # 1. the strategies in this process, 25 steps
    runs = {name: _strategy_run(pipe, name, one)
            for name in ("single", "chunk", "hybrid_ctx", "precond")}
    again = _strategy_run(pipe, "hybrid_ctx", one)
    same = np.array_equal(again["video"], runs["hybrid_ctx"]["video"])
    single_sha = hashlib.sha256(runs["single"]["video"].tobytes()).hexdigest()
    _require(single_sha == request_a_sha, "strategies: single's video is Request A's",
             {"single": single_sha, "request_a": request_a_sha})
    _require(same, "strategies: hybrid_ctx run twice is not bit-identical", {})
    pairs = boundary_pairs(chunk_bounds(runs["chunk"]["plan"]))
    base_video = runs["single"]["video"]
    for name, r in runs.items():
        plan = r["plan"]
        row = {"seconds": r["seconds"], "peak_gib": r["peak_bytes"] / 2**30,
               "chunks": [plan.num_chunks, plan.chunk_len] if plan else None,
               "temp_instab": temporal_instability(r["video"], pairs),
               "flow_err": flow_warp_error(r["video"], pairs),
               "max_level_diff_vs_single": int(np.abs(r["video"].astype(int)
                                                      - base_video.astype(int)).max()),
               "launches": r["launches"]}
        out["runs"][name] = row
        missing = [k for k in MODEL_PATH if r["launches"][k] == 0]
        _require(not missing, f"strategies: {name} never launched", missing)
        log(f"strategies: {name} {json.dumps({k: v for k, v in row.items() if k != 'launches'})}")
    out["hybrid_ctx_repeat_bitwise"] = same
    out["hybrid_ctx_repeat_seconds"] = again["seconds"]
    chunk_frames = runs["chunk"]["frames"]
    del runs, again
    torch.cuda.empty_cache()

    # 2. the value-preserving strategies on a one-rank NCCL group
    init_process_group(f"tcp://127.0.0.1:{free_port()}", 1, 0, torch.device("cuda", 0))
    try:
        mesh = make_mesh((1, 1, 1))
        ref = _strategy_run(pipe, "single", mesh, steps=NCCL_STEPS)
        nccl = {}
        for name in ("fsdp", "cp_exact", "cp_ulysses"):
            r = _strategy_run(pipe, name, mesh, steps=NCCL_STEPS)
            equal = torch.equal(r["frames"], ref["frames"])
            nccl[name] = {"bit_equal_to_single": equal, "seconds": r["seconds"],
                          "all_gathers": r["gathers"], "peak_gib": r["peak_bytes"] / 2**30}
            _require(equal and r["gathers"] > 0,
                     f"strategies: {name} on a one-rank NCCL group", nccl[name])
        nccl["single_seconds"] = ref["seconds"]
        log(f"strategies: one-rank NCCL group ({dist.get_backend()}), {NCCL_STEPS} steps "
            f"(cp_* at a seq axis of 1 run the fsdp program): {json.dumps(nccl)}")
        out["nccl_world_1"] = nccl
        routed, qkv = _routed_at_one_rank(pipe, mesh, NCCL_STEPS)
        routed["attention_held"] = _hold_ring_at_one_rank(*qkv, mesh)
        del qkv
        log(f"strategies: the exact-CP program inside ring_context at one rank, "
            f"{NCCL_STEPS} steps: {json.dumps(routed)}")
        out["routed_world_1"] = routed
        fsdp_peak = int(nccl["fsdp"]["peak_gib"] * 2**30)
        out["mesh_miner"] = _mesh_miner_memory(pipe, mesh, fsdp_peak)
        log(f"strategies: mesh miner: {json.dumps(out['mesh_miner'])}")
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # 3. every distinct kernel input of one chunked UNet call
    call = _chunked_unet_call(pipe)
    with recorded_kernel_inputs() as seen:
        call()
    torch.cuda.synchronize()
    held, rows = hold_recorded(seen, "one chunked UNet call (batch 4 x 9 frames)",
                               tag="strategies")
    bounds = launch_bounds(pipe.unet, call)
    out["held_per_unet_call"], out["bound_per_unet_call"] = held, bounds
    log("strategies: chunked UNet call, per kernel (launches, kernel ms, bound ms): "
        + json.dumps({k: [held.get(k, {}).get("launches"), held.get(k, {}).get("ms"),
                          bounds[k]["bound_ms"]] for k in MODEL_PATH}))
    with open(os.path.join(OUT_DIR, "strategies_held_inputs.json"), "w") as f:
        json.dump(rows, f, indent=1, default=str)

    # 4. a chunked round: hybrid_ctx miners (honest, lazy, a num_chunks liar)
    cfg = ValidatorConfig(width=576, height=320, num_frames=16, num_steps=25,
                          num_checkpoints=3, sample_size=3, ping_timeout_s=30,
                          timeout_s=600, results_dir=os.path.join(OUT_DIR, "chunked_round"))
    net = build_mock_network(n_miners=3, adversaries=["honest", "lazy", "honest"],
                             pipeline=pipe, validator_config=cfg, mesh_strategy="hybrid_ctx")
    liar = net.miners[2]
    honest_generate = liar._generate_with_proof

    def lie(req):
        resp = honest_generate(req)
        resp.num_chunks = 0  # claims no chunk plan while pinned to one
        return resp

    liar._generate_with_proof = lie
    report, wall, counts = _run_round(net, "round-hybrid-ctx", STRAT_PROMPT)
    line = _round_line(report, wall)
    line["launches"] = counts
    for uid, d in report["miners"].items():
        line["miners"][uid]["verify_engine"] = d.get("verify_engine")
    log(f"strategies: chunked round: {json.dumps(line)}")
    miners = report["miners"]
    honest, lazy, lying = miners["0"], miners["1"], miners["2"]
    _require(not honest.get("failed_check") and all(honest["checks"].values())
             and honest["verify_engine"] == "hybrid_ctx" and honest["regime_atol"] == 0.1
             and honest["reexec_bitwise"] is True and honest["score"] > 0,
             "chunked round: the honest hybrid_ctx miner", honest)
    _require(lazy.get("failed_check") == "reexecution" and lazy.get("cheat") is True,
             "chunked round: the lazy miner", lazy)
    _require(lying.get("failed_check") == "chunk_plan", "chunked round: the liar", lying)
    _require(net.ledger.requests["round-hybrid-ctx"].status == "distributed",
             "chunked round: ledger", net.ledger.requests["round-hybrid-ctx"].status)
    missing = [k for k in MODEL_PATH if counts[k] == 0]
    _require(not missing, "chunked round: kernels never launched", missing)
    out["round"] = line
    del net
    torch.cuda.empty_cache()

    # 5. the CLIs as subprocesses, on the card (no device flag)
    csv_path = os.path.join(OUT_DIR, "strategy.csv")
    if os.path.exists(csv_path):
        os.unlink(csv_path)
    proc, sec = _strategy_cli(["strategy", "--mode", "hybrid_ctx", "--world-size", "1",
                               "--emu", "wifi", "--csv", csv_path, "--model",
                               "zeroscope-v2-576w", "--perturb", "--prompt", STRAT_PROMPT,
                               "--seed", str(STRAT_SEED)], 900)
    with open(csv_path) as f:
        rows_csv = list(csv.DictReader(f))
    _require(len(rows_csv) == 1 and all(rows_csv[0][c] != "" for c in rows_csv[0]),
             "strategy CLI: one full CSV row", rows_csv)
    out["strategy_cli"] = dict(rows_csv[0], wall_s=sec)
    log(f"strategies: strategy CLI in {sec:.1f} s: {json.dumps(rows_csv[0])}")

    latent_path = os.path.join(OUT_DIR, "coordinator.npz")
    proc, sec = _strategy_cli(["coordinator", "--num-chunks", "2", "--transport", "socket",
                               "--model", "zeroscope-v2-576w", "--frames", "16", "--width",
                               "576", "--height", "320", "--steps", "25", "--perturb",
                               "--prompt", STRAT_PROMPT, "--seed", str(STRAT_SEED),
                               "--save-latent", latent_path], 900)
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    with np.load(latent_path) as saved:
        coord_latent, coord_video = saved["latent"], saved["video"]
    ref_latent, ref_video = _per_chunk_reference(pipe)
    batch4 = ((chunk_frames + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy()
    diff = np.abs(coord_video.astype(int) - batch4.astype(int))
    coord = {"wall_s": sec, "video_shape": res["video_shape"], "device": res["device"],
             "measured_network_bytes": res["measured_network_bytes"],
             "net_gather_s": res["net_gather_s"], "worker_s": res["worker_s"],
             "latent_bitwise_vs_per_chunk": bool(np.array_equal(coord_latent, ref_latent)),
             "video_bitwise_vs_per_chunk": bool(np.array_equal(coord_video, ref_video)),
             "max_level_diff_vs_batch4_chunk": int(diff.max()),
             "share_of_levels_differing_vs_batch4": float((diff > 0).mean())}
    _require(res["video_shape"] == [16, 320, 576, 3] and res["device"] == "cuda"
             and res["measured_network_bytes"] > 0, "coordinator CLI", res)
    _require(coord["latent_bitwise_vs_per_chunk"] and coord["video_bitwise_vs_per_chunk"],
             "coordinator CLI: bit for bit the per-chunk program", coord)
    log(f"strategies: coordinator CLI: {json.dumps(coord)}")
    out["coordinator_cli"] = coord
    out["seconds"] = time.perf_counter() - t_phase
    log(f"strategies: phase 10 in {out['seconds']:.1f} s")
    return out


def main():
    argv = sys.argv[1:]
    only = None
    cog_hf_only = argv == ["--cogvideox-hf"]
    if argv and not cog_hf_only:
        if len(argv) != 2 or argv[0] != "--kernels" \
                or not set(argv[1].split(",")) <= set(KERNEL_META):
            print(f"usage: chip_smoke.py [--kernels NAME[,NAME...] | --cogvideox-hf] (names: "
                  f"{', '.join(KERNEL_META)})", file=sys.stderr)
            return 2
        only = argv[1].split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
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
    for k, names in (("groupnorm", ("gn_fused", "gn_moments", "gn_apply")),
                     ("temporal_block", ("temporal_block_chain",)),
                     ("spatial_tail", ("spatial_tail_chain",)),
                     ("temporal_attention", ("temporal_attn_tma",)),
                     ("attention_f32", ("attention_f32_mma", "attention_f32_frames")),
                     ("geglu_ff", ("f32_gemm",)),
                     ("bias_epilogue", ("bias_epilogue_rows",))):
        lines = build[k]["ptxas"].splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and any(n in line for n in names):
                log(f"ptxas {k}: " + " | ".join(x.split("ptxas info    :")[-1].strip()
                                               for x in lines[i:i + 4]))

    if cog_hf_only:
        check_kernels(list(COG_HF_PATH))
        run_cogvideox_hf(smi)
        log(f"chip_smoke --cogvideox-hf: phases 2 (the block's kernels) and 14 passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    summary, rows = check_kernels(only)
    marks = [("start", t_start), ("1-2 build, kernel checks", time.perf_counter())]
    if only is not None:
        log(f"chip_smoke --kernels: {len(rows)} cases passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    with open(os.path.join(OUT_DIR, "kernel_checks.json"), "w") as f:
        json.dump({"device": smi, "rows": rows}, f, indent=1)

    t0 = time.perf_counter()
    check_against_cpu()
    log(f"reference check: {time.perf_counter() - t0:.1f} s")
    marks.append(("3 reference check", time.perf_counter()))
    pipe, launches, path = run_path(steps_a=25, smi=smi)
    marks.append(("4 path", time.perf_counter()))
    log(f"request A: root {path['root']} (the recorded {REQUEST_A_ROOT}...: "
        f"{'same' if path['root'].startswith(REQUEST_A_ROOT) else 'MOVED'})")
    _require(path["root"].startswith(REQUEST_A_ROOT), "request A's Merkle root",
             {"root": path["root"], "recorded": REQUEST_A_ROOT})
    try:  # the cache file (3.35 GB) goes whatever fails once it is written
        path["sharded_and_cache"] = run_sharded_and_cache(pipe, smi)
        marks.append(("12 sharded GroupNorm, cache", time.perf_counter()))
        path["network_round"] = run_network_round(pipe)
        marks.append(("5 network round", time.perf_counter()))
        torch.cuda.empty_cache()
        path["services"] = run_services(pipe, smi, CACHE_DIR)
        marks.append(("8 services", time.perf_counter()))
    finally:
        import shutil

        shutil.rmtree(CACHE_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    path["strategies"] = run_strategies(pipe, path["video_sha256"])
    marks.append(("10 strategies", time.perf_counter()))
    path["params_ckpt"] = run_params_ckpt(smi)
    marks.append(("11(c) params ckpt", time.perf_counter()))
    del pipe
    torch.cuda.empty_cache()
    path["cross_device_round"] = run_cross_device_round()
    marks.append(("6 cross-device round", time.perf_counter()))
    # phases 13 and 7 load one checkpoint; phase 7 deletes it once loaded
    written = write_full_checkpoint(FULL_CKPT)
    marks.append(("7 checkpoint write", time.perf_counter()))
    try:
        path["float32"] = run_float32(FULL_CKPT, smi)
    except BaseException:
        import shutil

        shutil.rmtree(FULL_CKPT, ignore_errors=True)
        raise
    marks.append(("13 float32", time.perf_counter()))
    path["xl"] = run_xl(FULL_CKPT, written, smi)
    marks.append(("7 xl", time.perf_counter()))
    path["families"] = run_families(smi)
    marks.append(("9 families", time.perf_counter()))
    path["cogvideox_hf"] = run_cogvideox_hf(smi)
    marks.append(("14 cogvideox-5b-hf", time.perf_counter()))
    path["phase_seconds"] = {name: round(t - marks[i][1], 1)
                             for i, (name, t) in enumerate(marks[1:])}
    with open(os.path.join(OUT_DIR, "path.json"), "w") as f:
        json.dump({"device": smi, "launches": launches, **path}, f, indent=1, default=str)

    kernels = []
    cross = path["cross_device_round"]["launches"]
    xl, f32 = path["xl"], path["float32"]
    xl_per_call = {k: dict(v, bound_ms=xl["bound_per_unet_call"][k]["bound_ms"])
                   for k, v in xl["held_per_unet_call"].items()}
    fam = path["families"]
    dit, svd = fam["dit"], fam["svd"]
    for name, s in summary.items():
        src, replaces = KERNEL_META[name]
        # phase 9: each family's path launches, and its new shapes' numbers
        families = {"launches_cogvideox_request": dit["request"]["launches"][name],
                    "launches_per_dit_call": dit["step"]["launches_per_dit_call"][name],
                    "launches_cogvideox_round": dit["round"]["launches"].get(name, 0),
                    "launches_svd_request": svd["request"]["launches"][name],
                    "svd_per_unet_call": None if name not in MODEL_PATH else dict(
                        svd["held_per_unet_call"][name],
                        bound_ms=svd["bound_per_unet_call"][name]["bound_ms"]),
                    "svd_vae_encode": svd["held_vae_encode"].get(name),
                    "svd_shapes": svd["shapes"].get(name),
                    "cogvideox_vae_frame": None if name not in dit["held_vae_frame"] else dict(
                        dit["held_vae_frame"][name],
                        bound_ms=dit["bound_vae_frame"][name]["bound_ms"]),
                    "cogvideox_round_held": dit["held_round"].get(name)}
        strat = path["strategies"]
        # phase 10: each strategy run's launches, the chunked call's numbers
        families.update({
            "launches_strategies": {k: v["launches"][name] for k, v in strat["runs"].items()},
            "launches_chunked_round": strat["round"]["launches"][name],
            "chunked_per_unet_call": None if name not in MODEL_PATH else dict(
                strat["held_per_unet_call"].get(name, {}),
                bound_ms=strat["bound_per_unet_call"][name]["bound_ms"],
                bound_launches=strat["bound_per_unet_call"][name]["launches"])})
        # phase 14: cogvideox-5b-hf's request and DiT call, its held inputs
        cog = path["cogvideox_hf"]
        families.update({
            "launches_cogvideox_hf_request": cog["request"]["launches"][name],
            "launches_per_cogvideox_hf_call": cog["step"]["launches_per_dit_call"][name],
            "cogvideox_hf_held": dict(cog["bias_epilogue"], **cog["block_kernels"]).get(name),
            "cogvideox_hf_flash": cog["flash"] if name == "flash_attention" else None})
        if name == "flash_attention":
            families["dit_shape"] = {k: dit["flash"][k] for k in (
                "shape", "ms", "library_ms", "bound_ms", "bound_by", "plain_slice_shape",
                "plain_ms_per_slice", "max_abs_err")}
            families["dit_held_shapes"] = [
                dict({k: f[k] for k in ("shape", "ms", "max_abs_err")},
                     bound_ms=bound_ms(*flash_cost(*f["shape"]))[0])
                for f in dit["round_flash"] + [dit["reduced_call"]["flash"]]]
        sharded = path["sharded_and_cache"]["gloo_ranks"]
        # phase 13: the float32 request's launches and one float32 UNet call's
        # kernel ms beside its bound
        families.update({
            "launches_cross_device_round": cross.get(name, 0),
            "float32_per_unet_call": f32["kernels_per_unet_call"].get(name),
            "float32_vae_frame": None if name not in f32["held_vae_frame"] else dict(
                f32["held_vae_frame"][name],
                bound_ms=f32["bound_vae_frame"][name]["bound_ms"])})
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "path": ("request_a" if name in MODEL_PATH else "float32_request"
                                 if name in F32_KERNELS else "phase12_gloo_ranks"
                                 if name in SHARDED_GN_PATH else "phase14_cogvideox_hf_request"
                                 if name in COG_HF_PATH else None),
                        "launches": f32["request"]["launches"][name] if name in F32_KERNELS
                        else sharded["launches"][name] if name in SHARDED_GN_PATH
                        else cog["request"]["launches"][name] if name in COG_HF_PATH
                        else launches[name],
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": "operations" if s["t_ops"] > s["t_bytes"]
                        else "bytes", "library_ms": s["library_ms"],
                        "launches_network_round": path["network_round"]["launches"][name],
                        "launches_services": {k: v.get(name, 0) for k, v in
                                              path["services"]["launches"].items()},
                        "launches_xl": path["xl"]["request"]["launches"][name],
                        "xl_per_unet_call": xl_per_call.get(name),
                        "xl_vae_frame": xl["held_vae_frame"].get(name), **families})
    w, ck = path["weights"], path["params_ckpt"]
    log(f"phase 11 ({smi}): (a) full-width weights equal to the JAX package's "
        f"(digest {w['digest']}, start-up {w['fast_init_s'] + w['perturb_s']:.2f} s); "
        f"(b) Request A on them: root {path['root']}, {path['seconds_per_request']:.2f} "
        f"s/request, steps {path['reexecution']['checks']} re-executed bitwise; (c) "
        f"--params-ckpt: " + (f"round completed in {ck['round_wall_s']} s"
                              if ck["tensorstore"] else "refused with exit 2 (no tensorstore)"))
    p12 = path["sharded_and_cache"]
    log(f"phase 12 ({smi}): (a) two-half frame-sharded GroupNorm on {p12['split']['shape']}: "
        f"moments bitwise {p12['split']['moments_bitwise']}, max_abs_err "
        f"{p12['split']['max_abs_err']:.3e} (tol {p12['split']['tol']:.3e}); (b) cache "
        f"miss {p12['cache']['miss_s']:.2f} s, hit {p12['cache']['hit_s']:.2f} s, digest "
        f"equal {p12['cache']['digest_equal']}; services' start-up on it "
        f"{json.dumps(path['services']['startup_s'])}; (c) two gloo ranks: launches "
        f"{json.dumps(p12['gloo_ranks']['launches_per_rank'])}, bitwise with (a) "
        f"{p12['gloo_ranks']['bitwise_vs_in_process_split']}")
    log(f"chip_smoke: seconds per phase {json.dumps(path['phase_seconds'])}")
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    log(smi)  # again near the end: the start of a long output may be cut off
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
