"""dvdx_tpu_torch command line.

    python -m dvdx_tpu_torch <command> [args...]

Commands:

  generate     one prompt -> video -> mp4, on the card unless --device cpu
  miner        serve a miner over HTTP (network.services)
  validator    serve a validator, its REST API and deposit listener
               (network.services)
  convert      inspect / convert a diffusers checkpoint (utils.convert)
  mock-round   one in-process network round: miners, validator, ledger
               (network.mock)
  strategy     one run of a distribution strategy, a CSV row of its metrics
               (parallel.runner; --world-size N starts N ranks)
  coordinator  chunks denoised by worker processes, stitched and decoded
               (parallel.coordinator)
  keys         keygen / sign / verify (verify.cli)
  econ         the economics pipeline: EV sweep, deposit bounds, sensitivity,
               plots (economics.run)

``miner`` and ``validator`` take the arguments of ``python -m
dvdx_tpu_torch.network.services miner|validator``; like ``generate``,
``strategy`` and ``coordinator`` they run on the card unless given
``--device cpu`` (or ``--cpu``).

``--model`` takes a registry name (seeded random weights, the JAX package's
for the same name and seed) or a diffusers checkpoint directory (its
weights and CLIP BPE tokenizer); ``miner`` and ``validator`` also take
``--params-ckpt DIR``, an orbax directory of shared weights.
"""

from __future__ import annotations

import sys


def _generate(argv) -> int:
    import argparse
    import time

    ap = argparse.ArgumentParser(prog="python -m dvdx_tpu_torch generate",
                                 description="text -> video -> mp4")
    ap.add_argument("--prompt", required=True)
    ap.add_argument("--negative-prompt", default="")
    ap.add_argument("--model", default="zeroscope-v2-576w",
                    help="registry name or diffusers checkpoint directory")
    ap.add_argument("--out", default="out.mp4")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=0, help="0 = the model's default")
    ap.add_argument("--width", type=int, default=0)
    ap.add_argument("--height", type=int, default=0)
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--guidance-scale", type=float, default=-1.0)
    ap.add_argument("--fps", type=int, default=8)
    ap.add_argument("--cfg-split", action="store_true",
                    help="the two CFG halves as two UNet calls (half the activations)")
    ap.add_argument("--segment-steps", type=int, default=0,
                    help=">0: drive the schedule in segments of this many steps")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--perturb", action="store_true",
                    help="perturb zero-init layers (signal without trained weights)")
    args = ap.parse_args(argv)

    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("generate: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2

    from .ops import rng as rng_ops
    from .pipelines.text2video import (build_segmented_runner, generate, resolve_pipeline,
                                       to_uint8)
    from .utils.video_io import encode_mp4

    pipe = resolve_pipeline(args.model, seed=args.seed, device=args.device)
    if args.perturb:
        from .utils.testing import perturb_zero_params

        perturb_zero_params(pipe, seed=args.seed + 1)
    spec = pipe.spec
    frames = args.frames or spec.default_frames
    width = args.width or spec.default_width
    height = args.height or spec.default_height
    steps = args.steps or spec.default_steps
    gs = spec.default_guidance_scale if args.guidance_scale < 0 else args.guidance_scale

    t0 = time.time()
    if args.segment_steps > 0:
        run = build_segmented_runner(pipe, num_frames=frames, height=height, width=width,
                                     num_steps=steps, guidance_scale=gs,
                                     segment_steps=args.segment_steps,
                                     cfg_split=args.cfg_split)
        ids = torch.from_numpy(pipe.tokenize([args.negative_prompt, args.prompt])).long()
        video = to_uint8(run(ids, rng_ops.base_key(args.seed))).cpu().numpy()
    else:
        video = generate(pipe, args.prompt, negative_prompt=args.negative_prompt,
                         seed=args.seed, num_frames=frames, height=height, width=width,
                         num_steps=steps, guidance_scale=gs, cfg_split=args.cfg_split)
    dt = time.time() - t0
    data = encode_mp4(video, fps=args.fps)
    with open(args.out, "wb") as f:
        f.write(data)
    device = (torch.cuda.get_device_name(pipe.device) if pipe.device.type == "cuda"
              else "cpu")
    print(f"wrote {args.out}: {video.shape[0]}f@{video.shape[2]}x{video.shape[1]}, "
          f"{len(data)} bytes, {dt:.1f}s (device={device})")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "generate":
        return _generate(rest)
    if cmd in ("miner", "validator"):
        from .network.services import main as services_main

        return services_main([cmd] + rest)
    if cmd == "convert":
        from .utils.convert import main as convert_main

        return convert_main(rest)
    if cmd == "strategy":
        from .parallel.runner import main as runner_main

        return runner_main(rest)
    if cmd == "coordinator":
        from .parallel.coordinator import main as coordinator_main

        return coordinator_main(rest)
    if cmd == "mock-round":
        from .network.mock import demo

        demo(rest)
        return 0
    if cmd == "keys":
        from .verify.cli import main as keys_main

        return keys_main(rest)
    if cmd == "econ":
        from .economics.run import main as econ_main

        return econ_main(rest)
    print(f"unknown command {cmd!r}\n")
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main())
