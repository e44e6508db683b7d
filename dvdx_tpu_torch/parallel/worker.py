"""Chunk worker process: denoise one frame range, return the latent chunk.

Counterpart of ``dvdx_tpu/parallel/worker.py``. The worker derives its own
input from (seed, frame range) -- the counter-based base noise of those
frames -- so no input tensor crosses the process boundary; the (L, h, w, C)
float32 result goes back as an npz file (``--out``) or over a TCP socket
(``--send-to``, framed ``DVDXCHNK`` + start + length). ``--weights`` loads a
converted parameter tree in place of the model's seeded random weights.

  python -m dvdx_tpu_torch.parallel.worker --seed 7 --start 4 --length 6 \\
      --model zeroscope-tiny --out chunk1.npz --device cpu
"""

from __future__ import annotations

import argparse
import io
import json
import socket
import struct
import sys
import time

import numpy as np
import torch


def chunk_pipeline(model: str, device, weights: str = "", perturb: bool = False,
                   param_seed: int = 0):
    """The pipeline a worker (and the coordinator's decode) runs: ``model``
    with the parameter tree of ``weights`` (a flat npz) where given, else its
    seeded random weights, their zero leaves perturbed under ``perturb``."""
    from ..pipelines.text2video import build_pipeline
    from ..utils.bridge import load_flat_npz, load_pipeline_params
    from ..utils.testing import perturb_zero_params

    pipe = build_pipeline(model, seed=param_seed, device=device)
    if weights:
        load_pipeline_params(pipe, load_flat_npz(weights))
    if perturb:
        perturb_zero_params(pipe, seed=99)
    return pipe


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dvdx_tpu_torch.parallel.worker",
                                 description="dvdx chunk worker")
    ap.add_argument("--model", default="zeroscope-tiny")
    ap.add_argument("--prompt", required=True)
    ap.add_argument("--negative-prompt", default="")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--start", type=int, required=True)
    ap.add_argument("--length", type=int, required=True)
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--height", type=int, default=32)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--guidance", type=float, default=7.5)
    ap.add_argument("--out", default="")
    ap.add_argument("--send-to", default="",
                    help="host:port: stream the chunk over a TCP socket")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--perturb", action="store_true")
    ap.add_argument("--param-seed", type=int, default=0)
    ap.add_argument("--weights", default="",
                    help="a converted parameter tree (flat npz, as `python -m dvdx_tpu_torch "
                         "convert --out` writes it) in place of the seeded random weights")
    ap.add_argument("--threads", type=int, default=0,
                    help="CPU threads (0: torch's default)")
    args = ap.parse_args(argv)
    if not args.out and not args.send_to:
        ap.error("need --out and/or --send-to")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("worker: no CUDA device; pass --device cpu", file=sys.stderr)
        return 2

    from ..ops import rng as rng_ops
    from ..pipelines.text2video import denoise

    if args.threads > 0:
        torch.set_num_threads(args.threads)
    t0 = time.time()
    pipe = chunk_pipeline(args.model, args.device, args.weights, args.perturb,
                          args.param_seed)
    spec = pipe.spec
    ds = spec.vae.downscale
    shape = (args.height // ds, args.width // ds, spec.latent_channels)
    sched = spec.ddim_schedule(args.steps)
    ids = torch.from_numpy(pipe.tokenize([args.negative_prompt, args.prompt])).long()
    with torch.inference_mode():
        hidden, _ = pipe.text_encoder(ids.to(pipe.device))
        z0 = rng_ops.frame_range_noise(rng_ops.base_key(args.seed), args.start,
                                       args.length, shape, device=pipe.device)
        z = denoise(pipe.unet, sched, z0[None].to(torch.bfloat16), hidden[1:2],
                    hidden[0:1], args.guidance)
        z = z[0].float().cpu().numpy()
    meta = dict(latent=z, start=args.start, length=args.length, seed=args.seed,
                steps=args.steps)
    sent = 0
    if args.out:
        np.savez(args.out, **meta)
    if args.send_to:
        buf = io.BytesIO()
        np.savez(buf, **meta)
        payload = buf.getvalue()
        host, port = args.send_to.rsplit(":", 1)
        with socket.create_connection((host, int(port)), timeout=60) as s:
            s.sendall(b"DVDXCHNK" + struct.pack(">II", args.start, len(payload)))
            s.sendall(payload)
        sent = len(payload)
    print(json.dumps({"worker": "ok", "out": args.out or args.send_to,
                      "frames": [args.start, args.start + args.length],
                      "sent_bytes": sent, "device": str(pipe.device),
                      "elapsed_s": round(time.time() - t0, 2)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
