"""Where one request's time goes on the card: a device-time breakdown of the
denoise step and the VAE decode of zeroscope-v2-576w.

    python -m dvdx_tpu_torch.utils.profile_step [--xl]

``--xl`` profiles zeroscope-v2-xl's step as the CLI runs it (24 frames at
1024x576, cfg_split: two batch-1 UNet calls a step) instead.

Builds the model with seeded random weights (zero-init leaves perturbed, as
``chip_smoke.py`` does), runs one warm-up step, then traces two
classifier-free-guided DDIM steps and one frame's VAE decode with
``torch.profiler``. Device kernels are grouped into the port's kernels,
matrix products, convolutions and everything else; the idle share is the
part of the traced window in which no kernel ran. The fused spatial tail and
temporal block are grouped as their three launches each (the chain and the
two GEGLU products, whose kernels carry the library's name in their template
arguments). Needs a CUDA card; writes the breakdown to
``chiprun_out/profile_step.json`` (``profile_step_xl.json`` with ``--xl``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

STEPS = 2
OUT = os.path.join("chiprun_out", "profile_step.json")

# kernel-name fragments -> group (first match wins): the GEGLU products of
# the fused kernels (geglu_stage<spatial_tail_ff, ...>, geglu_stage<
# temporal_block_ff, ...>) land in their fused kernel's group beside its
# chain (spatial_tail_chain, temporal_block_chain<C>), geglu_ff's own
# (geglu_stage<geglu_ff_site, ...>) in geglu_ff's; GroupNorm is one kernel,
# gn_fused (a bare "gn_" would also match ATen's sign_ and assign_ kernels);
# the float32 kernels carry their caller's name in their template arguments
# (f32_gemm<spatial_tail_f32, ...>, attention_f32_frames<temporal_block_f32,
# ...>, f32_gemm<geglu_ff_site, ...>), so the fused kernels' float32 forms
# land in their own groups; float32 flash and frame-axis attention share
# attention_f32's three bodies (attention_f32_mma / _frames / _rows
# <attention_f32_site, ...>)
GROUPS = (
    ("fused_spatial_tail", ("spatial_tail_",)),
    ("fused_temporal_block", ("temporal_block_",)),
    ("flash_attention", ("flash_fwd",)),
    ("temporal_attention", ("temporal_attn",)),
    ("attention_f32", ("attention_f32",)),
    ("geglu_ff", ("geglu_ff_", "geglu_stage")),
    ("group_norm_act", ("gn_fused",)),
    ("convolution", ("conv", "fprop", "dgrad", "implicit", "winograd", "nchw", "nhwc")),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
)


def group_of(kernel_name: str) -> str:
    low = kernel_name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals (microseconds)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def breakdown(prof, wall_s: float) -> dict:
    by_group, by_kernel, intervals = {}, {}, []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        intervals.append((ev.time_range.start, ev.time_range.end))
        g = group_of(ev.name)
        by_group[g] = by_group.get(g, 0.0) + us
        by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + us
    busy = _busy_us(intervals)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": (1.0 - busy / (wall_s * 1e6)) if intervals else None,
            "kernels": len(intervals),
            "group_ms": {g: us / 1e3 for g, us in sorted(by_group.items(),
                                                          key=lambda kv: -kv[1])},
            "top_kernels_ms": [[name[:120], us / 1e3] for name, us in top]}


def main(argv=None) -> int:
    xl = "--xl" in (sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from ..ops import rng
    from ..ops.scheduler import make_ddim_schedule
    from ..pipelines.text2video import build_pipeline, cfg_denoise_step, encode_prompts
    from .testing import perturb_zero_params

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    model = "zeroscope-v2-xl" if xl else "zeroscope-v2-576w"
    pipe = perturb_zero_params(build_pipeline(model, seed=0), seed=99)
    spec = pipe.spec
    sched = make_ddim_schedule(spec.default_steps)
    with torch.inference_mode():
        hidden = encode_prompts(pipe, ["", "a red panda rides a bicycle"])
        uncond, cond = hidden[0:1], hidden[1:2]
        ds = spec.vae.downscale
        z = rng.video_noise(rng.base_key(7), spec.default_frames,
                            (spec.default_height // ds, spec.default_width // ds,
                             spec.latent_channels), device="cuda")[None].bfloat16()

        def steps(z, n):
            for i in range(n):
                z, _ = cfg_denoise_step(pipe.unet, sched, z, i, cond, uncond,
                                        spec.default_guidance_scale, cfg_split=xl)
            return z

        steps(z, 1)
        torch.cuda.synchronize()
        result = {"device": smi, "model": model, "cfg_split": xl, "steps": STEPS}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            z = steps(z, STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        result["denoise"] = breakdown(prof, wall)
        result["denoise"]["ms_per_step"] = wall * 1e3 / STEPS
        frame = z[0, :1].float()
        pipe.vae_decoder(frame)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pipe.vae_decoder(frame)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        result["vae_decode_one_frame"] = breakdown(prof, wall)
    for part in ("denoise", "vae_decode_one_frame"):
        r = result[part]
        groups = " ".join(f"{g}={ms:.2f}" for g, ms in r["group_ms"].items())
        print(f"profile {part}: wall {r['wall_ms']:.2f} ms, device busy "
              f"{r['device_busy_ms']:.2f} ms, idle share {r['idle_share']}, "
              f"{r['kernels']} kernels; ms by group: {groups}", flush=True)
    out = OUT.replace(".json", "_xl.json") if xl else OUT
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
