"""Multi-process chunk coordinator: ``python -m dvdx_tpu_torch coordinator``.

Counterpart of ``dvdx_tpu/parallel/coordinator.py``: orchestration without a
process group. Each chunk of the plan goes to a worker process
(``parallel.worker``) that re-derives its frames' base noise from the seed
and denoises them; the chunks come back as npz files (``transport='file'``)
or over localhost TCP sockets (``'socket'``, with the measured payload bytes
and receive times), a failed chunk is re-run once by a fresh worker, and the
coordinator ramp-blends them (``parallel.latent_chunking``) and decodes
once. Workers run on ``device`` (the card by default).

  python -m dvdx_tpu_torch coordinator --prompt "lava flow" --num-chunks 2 \\
      --frames 8 --model zeroscope-tiny --device cpu --out video.mp4
"""

from __future__ import annotations

import argparse
import io
import json
import os
import socket
import struct
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from .chunking import plan_chunks
from .latent_chunking import chunk_bounds, stitch_chunks

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _recv_chunk(conn):
    """One framed chunk off ``conn`` -> (start, payload length, payload,
    seconds); raises on a short or corrupt stream."""
    r0 = time.time()
    header = b""
    while len(header) < 16:
        part = conn.recv(16 - len(header))
        if not part:
            raise IOError("short chunk header")
        header += part
    if header[:8] != b"DVDXCHNK":
        raise IOError(f"bad chunk magic {header[:8]!r}")
    start, ln = struct.unpack(">II", header[8:16])
    payload = bytearray()
    while len(payload) < ln:
        part = conn.recv(min(1 << 20, ln - len(payload)))
        if not part:
            raise IOError("short chunk stream")
        payload += part
    return start, ln, bytes(payload), time.time() - r0


def run_coordinated(prompt: str, *, model: str = "zeroscope-tiny", num_chunks: int = 2,
                    overlap: int = 2, num_frames: int = 8, width: int = 32,
                    height: int = 32, steps: int = 3, seed: int = 0, device="cuda",
                    perturb: bool = False, weights: str = "", workdir: Optional[str] = None,
                    launcher: Optional[Callable[[List[str]], subprocess.Popen]] = None,
                    transport: str = "file", timeout_s: float = 600.0) -> dict:
    """Fan the chunks out to worker processes, stitch, decode. ``weights``:
    a converted parameter tree (flat npz) that the workers and the decode
    load in place of ``model``'s seeded random weights. Returns the run's
    metrics, the stitched float32 latent under 'latent' and the uint8
    video under 'video'."""
    plan = plan_chunks(num_frames, num_chunks, overlap)
    workdir = workdir or tempfile.mkdtemp(prefix="dvdx_coord_")
    os.makedirs(workdir, exist_ok=True)
    bounds = chunk_bounds(plan)
    launch = launcher or (lambda c: subprocess.Popen(
        c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO_ROOT))
    device = str(device)

    server = None
    if transport == "socket":
        server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        server.bind(("127.0.0.1", 0))
        server.listen(plan.num_chunks * 2)
        sock_addr = f"127.0.0.1:{server.getsockname()[1]}"

    def launch_worker(i: int, tag: str = ""):
        start, end = bounds[i]
        out = os.path.join(workdir, f"chunk_{i}{tag}.npz")
        cmd = [sys.executable, "-m", "dvdx_tpu_torch.parallel.worker",
               "--model", model, "--prompt", prompt, "--seed", str(seed),
               "--start", str(start), "--length", str(end - start),
               "--width", str(width), "--height", str(height), "--steps", str(steps),
               "--device", device]
        cmd += ["--send-to", sock_addr] if transport == "socket" else ["--out", out]
        if torch.device(device).type == "cpu":  # the workers share the host's cores
            cmd += ["--threads", str(max(1, (os.cpu_count() or 1) // plan.num_chunks))]
        if perturb:
            cmd.append("--perturb")
        if weights:
            cmd += ["--weights", os.path.abspath(weights)]
        return launch(cmd), out, i

    chunks: List[Optional[np.ndarray]] = [None] * plan.num_chunks
    start_to_idx = {bounds[i][0]: i for i in range(plan.num_chunks)}
    net = {"measured_network_bytes": 0, "net_gather_s": 0.0, "per_chunk_recv_s": []}

    def collect_sockets(procs):
        """Receive chunks until every launched worker delivered or exited."""
        pending = {i for _, _, i in procs}
        server.settimeout(1.0)
        gather_t0 = None
        deadline = time.time() + timeout_s
        draining = False
        while pending and time.time() < deadline:
            try:
                conn, _ = server.accept()
            except socket.timeout:
                if draining:
                    break
                if all(p.poll() is not None for p, _, _ in procs):
                    draining = True  # one more sweep of the accept backlog
                continue
            try:
                with conn:
                    gather_t0 = gather_t0 or time.time()
                    start, ln, payload, recv_s = _recv_chunk(conn)
                i = start_to_idx.get(start)
                if i is None:
                    raise IOError(f"unknown chunk start {start}")
                chunks[i] = np.load(io.BytesIO(payload))["latent"]
            except Exception as e:  # a corrupt delivery goes to the retry
                print(f"[coordinator] discarded bad chunk delivery: {e}", file=sys.stderr)
                continue
            net["measured_network_bytes"] += 16 + ln
            net["per_chunk_recv_s"].append(round(recv_s, 4))
            pending.discard(i)
        if gather_t0 is not None:
            net["net_gather_s"] = round(time.time() - gather_t0, 4)

    def collect(procs):
        failures = []
        if transport == "socket":
            collect_sockets(procs)
        for proc, out, i in procs:
            try:
                _stdout, stderr = proc.communicate(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                _stdout, stderr = proc.communicate()
            delivered = chunks[i] is not None if transport == "socket" \
                else os.path.exists(out)
            if proc.returncode != 0 or not delivered:
                failures.append((i, (stderr or b"")[-400:].decode(errors="replace")))
                continue
            if transport == "file":
                chunks[i] = np.load(out)["latent"]
        return failures

    t0 = time.time()
    try:
        failures = collect([launch_worker(i) for i in range(plan.num_chunks)])
        if failures:
            # a chunk is a pure function of (seed, range): re-run it once
            failures = collect([launch_worker(i, "_retry") for i, _err in failures])
            if failures:
                raise RuntimeError(f"workers failed after retry: {failures}")
    finally:
        if server is not None:
            server.close()
    worker_s = time.time() - t0

    latent = stitch_chunks(chunks, plan)  # (F, h, w, C) float32

    from ..models.vae import decode_frames_tiled
    from ..pipelines.text2video import to_uint8
    from .worker import chunk_pipeline

    pipe = chunk_pipeline(model, device, weights, perturb)
    with torch.inference_mode():
        frames = decode_frames_tiled(pipe.vae_decoder,
                                     torch.from_numpy(latent).to(pipe.device))
        video = to_uint8(frames).cpu().numpy()
    return {"video": video, "latent": latent, "num_chunks": plan.num_chunks,
            "chunk_len": plan.chunk_len, "worker_s": round(worker_s, 2),
            "total_s": round(time.time() - t0, 2), "workdir": workdir,
            "transport": transport, "device": device,
            **(net if transport == "socket" else {})}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dvdx_tpu_torch coordinator",
                                 description="dvdx multi-process chunk coordinator")
    ap.add_argument("--prompt", default="a red panda climbing a tree")
    ap.add_argument("--model", default="zeroscope-tiny")
    ap.add_argument("--num-chunks", type=int, default=2)
    ap.add_argument("--overlap", type=int, default=2)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--height", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="the workers' device: cuda or cpu")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--perturb", action="store_true")
    ap.add_argument("--weights", default="",
                    help="a converted parameter tree (flat npz, `convert --out`) for the "
                         "workers and the decode")
    ap.add_argument("--transport", default="file", choices=["file", "socket"])
    ap.add_argument("--out", default="", help="mp4 path")
    ap.add_argument("--save-latent", default="", help="npz path for the stitched latent")
    args = ap.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("coordinator: no CUDA device; pass --device cpu", file=sys.stderr)
        return 2
    res = run_coordinated(args.prompt, model=args.model, num_chunks=args.num_chunks,
                          overlap=args.overlap, num_frames=args.frames, width=args.width,
                          height=args.height, steps=args.steps, seed=args.seed,
                          device=args.device, perturb=args.perturb, weights=args.weights,
                          transport=args.transport)
    video, latent = res.pop("video"), res.pop("latent")
    if args.out:
        from ..utils.video_io import encode_mp4

        with open(args.out, "wb") as f:
            f.write(encode_mp4(video, fps=8))
        res["out"] = args.out
    if args.save_latent:
        np.savez(args.save_latent, latent=latent, video=video)
    res["video_shape"] = list(video.shape)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
