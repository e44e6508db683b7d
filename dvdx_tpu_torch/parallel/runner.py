"""Strategy benchmark: ``python -m dvdx_tpu_torch strategy``.

Counterpart of ``dvdx_tpu/parallel/runner.py``: one run of one strategy at
one geometry, one row of the JAX runner's ``CSV_COLUMNS`` (latency, memory,
communication volume, the stitch all-gather's time, boundary temporal
metrics). On the port:

* ``--world-size N`` runs N ranks, started here as processes (NCCL on the
  card, card r for rank r; gloo with ``--device cpu``); 1 runs in this
  process on a one-rank group. ``--mesh`` factors the ranks (default
  1,1,N).
* ``ici_gather_s`` is a timed all-gather of the chunk-sharded latent on the
  mesh's (data, seq) group (CUDA events on the card, a barrier on the CPU);
  the WAN emulation (``--emu wifi|ethernet`` or the explicit knobs) adds the
  modelled delay of the analytic communication volume on top, as the JAX
  runner does.
* peak / end memory are ``torch.cuda.max_memory_allocated`` /
  ``memory_allocated`` of rank 0's card (the host's peak RSS on the CPU).

  python -m dvdx_tpu_torch strategy --mode hybrid_ctx --model zeroscope-v2-576w \\
      --frames 16 --steps 25 --emu wifi --csv out.csv
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import random
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

CSV_COLUMNS = [
    "timestamp", "mode", "world_size", "mesh", "model", "width", "height",
    "frames", "steps", "batch", "num_chunks", "overlap", "context_weight", "emu",
    "latency_s", "compute_s", "throughput_fps", "peak_mem_mb", "end_mem_mb",
    "param_mb_per_device", "network_bytes", "ici_gather_s", "net_gather_s",
    "net_reduce_s", "temp_instab", "flow_err",
]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure_gather_s(mesh, shape, dtype, reps: int = 3):
    """The stitch collective, measured: the all-gather of a (shape[0], ...)
    tensor split by rows over the mesh's (data, seq) group. Returns
    (seconds per gather, bytes each rank receives); (0.0, 0) on one rank."""
    axes = ("data", "seq")
    size, group = mesh.size(axes), mesh.group(axes)
    if size <= 1 or group is None:
        return 0.0, 0
    local = torch.zeros((shape[0] // size,) + tuple(shape[1:]), dtype=dtype,
                        device=mesh.device)
    parts = [torch.empty_like(local) for _ in range(size)]
    dist.all_gather(parts, local, group=group)  # warm-up: connections, buffers
    if mesh.device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            dist.all_gather(parts, local, group=group)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / reps
    else:
        dist.barrier(group=group)
        t0 = time.perf_counter()
        for _ in range(reps):
            dist.all_gather(parts, local, group=group)
        dist.barrier(group=group)
        dt = (time.perf_counter() - t0) / reps
    return dt, local.numel() * local.element_size() * (size - 1)


def estimate_comm_bytes(strategy, mesh, plan, param_bytes: int, steps: int,
                        latent_bytes_per_chunk: int) -> dict:
    """Analytic per-run communication volume by collective type (the JAX
    runner's model)."""
    model, seq = mesh.shape["model"], mesh.shape["seq"]
    gather = reduce_ = 0
    if strategy.shard_params and model > 1:
        gather += int(param_bytes * (model - 1) / model) * steps
    if (strategy.chunked or strategy.exact_cp) and seq > 1:
        n = plan.num_chunks if plan is not None else seq
        gather += int(latent_bytes_per_chunk * n * (seq - 1) / seq)
    if strategy.context_weight > 0 and seq > 1:
        reduce_ += latent_bytes_per_chunk
    return {"gather": gather, "reduce": reduce_, "total": gather + reduce_}


def wan_delay_s(nbytes: int, bw_mbps: float, rtt_ms: float, jitter_ms: float,
                rng: random.Random) -> float:
    from ..network.transport import WANProfile

    return WANProfile("emu", bandwidth_mbps=bw_mbps, rtt_ms=rtt_ms,
                      jitter_ms=jitter_ms).delay_s(nbytes, rng)


def device_mem_mb(device) -> tuple:
    """(peak, now) MB: the card's allocator, or the host's peak RSS."""
    if torch.device(device).type == "cuda":
        return (torch.cuda.max_memory_allocated(device) / 2**20,
                torch.cuda.memory_allocated(device) / 2**20)
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 0.0


def run_one(args, mesh) -> dict:
    """One timed run of ``args.mode`` on ``mesh`` (every rank calls it);
    the CSV row."""
    from ..pipelines.text2video import build_pipeline
    from ..ops import rng as rng_ops
    from ..scoring.temporal import boundary_pairs, flow_warp_error, temporal_instability
    from ..utils.testing import perturb_zero_params
    from .latent_chunking import chunk_bounds
    from .sharding import sharded_size_per_device
    from .strategies import build_runner, get_strategy

    dev = mesh.device
    pipe = build_pipeline(args.model, seed=args.param_seed, device=dev)
    if args.perturb:
        perturb_zero_params(pipe, seed=99)
    modules = {"unet": pipe.unet, "text": pipe.text_encoder, "vae_dec": pipe.vae_decoder}
    param_bytes = sum(p.numel() * p.element_size() for p in pipe.parameters())
    overrides = {}
    if args.num_chunks:
        overrides["num_chunks"] = args.num_chunks
    if args.overlap is not None:
        overrides["overlap"] = args.overlap
    if args.context_weight is not None:
        overrides["context_weight"] = args.context_weight
    strategy = get_strategy(args.mode, **overrides)
    param_mb = sharded_size_per_device(modules, mesh, strategy.shard_params) / 2**20

    runner = build_runner(pipe, strategy, mesh, num_frames=args.frames, height=args.height,
                          width=args.width, num_steps=args.steps,
                          guidance_scale=args.guidance_scale, batch_size=args.batch)
    ids = torch.from_numpy(pipe.tokenize(["", args.prompt])).long()
    key = rng_ops.base_key(args.seed)
    frames = runner(ids, key)  # warm-up (kernel builds, allocator), not timed
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    frames = runner(ids, key)
    _sync(dev)
    compute_s = time.time() - t0

    ds = pipe.spec.vae.downscale
    lh, lw, c = args.height // ds, args.width // ds, pipe.spec.latent_channels
    plan = runner.plan
    lat_bytes = (plan.chunk_len if plan else args.frames) * lh * lw * c * 2
    comm = estimate_comm_bytes(strategy, mesh, plan, param_bytes, args.steps, lat_bytes)
    ici_gather_s = 0.0
    if strategy.chunked or strategy.exact_cp:
        n = plan.num_chunks if plan else args.frames
        rows = (args.batch * n, plan.chunk_len if plan else 1, lh, lw, c)
        ici_gather_s, _ = measure_gather_s(mesh, rows, torch.bfloat16)
    rng_h = random.Random(args.seed)
    net_gather_s, net_reduce_s = ici_gather_s, 0.0
    if args.emu != "ideal":
        net_gather_s = ici_gather_s + wan_delay_s(comm["gather"], args.emu_bw_mbps,
                                                  args.emu_rtt_ms, args.emu_jitter_ms, rng_h)
        net_reduce_s = wan_delay_s(comm["reduce"], args.emu_bw_mbps, args.emu_rtt_ms,
                                   args.emu_jitter_ms, rng_h)
        time.sleep(min(net_gather_s + net_reduce_s, 10.0))
    latency_s = compute_s + net_gather_s + net_reduce_s
    peak_mb, end_mb = device_mem_mb(dev)

    video = ((frames.float().cpu() + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).numpy()
    if args.batch > 1:
        video = video[0]
    temp_instab = flow_err = 0.0
    if plan is not None and plan.num_chunks > 1:
        pairs = boundary_pairs(chunk_bounds(plan))
        temp_instab = temporal_instability(video, pairs)
        flow_err = flow_warp_error(video, pairs)
    if args.save_video and mesh.rank == 0:
        from ..utils.video_io import encode_mp4

        with open(args.save_video, "wb") as f:
            f.write(encode_mp4(video, fps=8))
    runner.close()
    return {
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "mode": args.mode, "world_size": mesh.world_size,
        "mesh": ",".join(str(d) for d in mesh.dims), "model": args.model,
        "width": args.width, "height": args.height, "frames": args.frames,
        "steps": args.steps, "batch": args.batch,
        "num_chunks": plan.num_chunks if plan else 1,
        "overlap": strategy.overlap if strategy.chunked else 0,
        "context_weight": strategy.context_weight, "emu": args.emu,
        "latency_s": round(latency_s, 4), "compute_s": round(compute_s, 4),
        "throughput_fps": round(args.batch * args.frames / latency_s, 3),
        "peak_mem_mb": round(peak_mb, 1), "end_mem_mb": round(end_mb, 1),
        "param_mb_per_device": round(param_mb, 1),
        "network_bytes": comm["total"], "ici_gather_s": round(ici_gather_s, 5),
        "net_gather_s": round(net_gather_s, 4), "net_reduce_s": round(net_reduce_s, 4),
        "temp_instab": round(temp_instab, 5), "flow_err": round(flow_err, 5),
    }


def _rank_row(rank: int, world: int, device, args):
    from .mesh import make_mesh

    row = run_one(args, make_mesh(args.mesh_shape, device=device))
    return row if rank == 0 else None


def _emu_presets():
    from ..network.transport import WAN_PRESETS

    return {name: (p.bandwidth_mbps, p.rtt_ms, p.jitter_ms)
            for name, p in WAN_PRESETS.items()}


EMU_PRESETS = _emu_presets()
MODES = ["single", "fsdp", "chunk", "hybrid", "hybrid_ctx", "cp_exact", "cp_ulysses",
         "precond"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m dvdx_tpu_torch strategy",
                                 description="dvdx distributed strategy benchmark")
    ap.add_argument("--mode", default="hybrid_ctx", choices=MODES)
    ap.add_argument("--world-size", type=int, default=1,
                    help="ranks, started here (1: this process)")
    ap.add_argument("--mesh", default="", help="data,model,seq (default 1,1,world)")
    ap.add_argument("--model", default="zeroscope-tiny")
    ap.add_argument("--prompt", default="a red panda climbing a tree")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--guidance_scale", type=float, default=7.5)
    ap.add_argument("--num_chunks", type=int, default=0)
    ap.add_argument("--overlap", type=int, default=None)
    ap.add_argument("--context_weight", type=float, default=None)
    ap.add_argument("--batch", type=int, default=1,
                    help="videos per run, split over the data mesh axis")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--param_seed", type=int, default=0)
    ap.add_argument("--perturb", action="store_true",
                    help="fill zero-init layers (random-weight demos)")
    ap.add_argument("--emu", default="ideal", choices=list(EMU_PRESETS))
    ap.add_argument("--emu_bw_mbps", type=float, default=None)
    ap.add_argument("--emu_rtt_ms", type=float, default=None)
    ap.add_argument("--emu_jitter_ms", type=float, default=None)
    ap.add_argument("--csv", default="")
    ap.add_argument("--save_video", default="")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="seconds the ranks may run (--world-size > 1)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("strategy: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    from ..models.zoo import get_model_spec
    from .mesh import free_port, init_process_group, make_mesh, run_ranks

    spec = get_model_spec(args.model)
    args.width = args.width or spec.default_width
    args.height = args.height or spec.default_height
    args.frames = args.frames or spec.default_frames
    args.steps = args.steps or spec.default_steps
    bw, rtt, jit = EMU_PRESETS[args.emu]
    args.emu_bw_mbps = args.emu_bw_mbps if args.emu_bw_mbps is not None else bw
    args.emu_rtt_ms = args.emu_rtt_ms if args.emu_rtt_ms is not None else rtt
    args.emu_jitter_ms = args.emu_jitter_ms if args.emu_jitter_ms is not None else jit
    args.mesh_shape = (tuple(int(x) for x in args.mesh.split(",")) if args.mesh
                       else (1, 1, args.world_size))
    if int(np.prod(args.mesh_shape)) != args.world_size:
        print(f"strategy: mesh {args.mesh_shape} does not use {args.world_size} ranks",
              file=sys.stderr)
        return 2

    if args.world_size == 1:
        device = torch.device(args.device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", 0)
        init_process_group(f"tcp://127.0.0.1:{free_port()}", 1, 0, device)
        try:
            row = run_one(args, make_mesh(args.mesh_shape, device=device))
        finally:
            dist.destroy_process_group()
    else:
        row = run_ranks(_rank_row, args.world_size, args=(args,), device=args.device,
                        timeout_s=args.timeout)[0]
    print(json.dumps(row))
    if args.csv:
        exists = os.path.exists(args.csv)
        with open(args.csv, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=CSV_COLUMNS)
            if not exists:
                w.writeheader()
            w.writerow(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
