"""Long-running neuron services: ``python -m dvdx_tpu_torch miner|validator``.

Counterpart of ``dvdx_tpu/network/services.py``. A miner serves its handler
over HTTP (``http_transport.serve_neuron``) and registers with, and resyncs
the registry from, a validator's REST API. A validator runs the deposit
listener, the REST API (``api.create_app``) and the round loop, which claims
each request once its prompt is attached and runs ``Validator.run_round``
over the registered miners.

  # terminal 1: the validator (hosts the registry and the REST API)
  python -m dvdx_tpu_torch validator --api-port 8100 --model zeroscope-tiny --perturb

  # terminals 2..N: miners
  python -m dvdx_tpu_torch miner --port 8201 --validator-api 127.0.0.1:8100 \\
      --model zeroscope-tiny --perturb

A miner with ``--mesh data,model,seq`` generates through ``--mesh-strategy``
(fsdp by default) over that many ranks: the service is rank 0 and starts the
other ranks itself, one process each (NCCL on the card, card r for rank r;
gloo on the CPU), which follow its generations. ``--mesh-strategy`` alone
(a chunked one: chunk, hybrid, hybrid_ctx) runs that program on one device.

Both run on the card unless given ``--device cpu`` (or ``--cpu``, the JAX
package's spelling). The miner writes ``miner_metrics.json`` into its working
directory at every sync, the validator ``validator_metrics.json`` and
``validator_state.npz`` into ``--results-dir`` after every round; each
metrics file also holds the process's kernel launch counts.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time
from typing import Callable, Optional

from ..ops.kernels import launch_counts
from ..verify.proof import Keypair, sign_registration
from .api import create_app, serve_api
from .base import Registry
from .deposit_listener import DepositListener
from .http_transport import HttpTransport, serve_neuron
from .ledger import Ledger
from .miner import Miner, MinerConfig
from .validator import Validator, ValidatorConfig

def _keypair(seed: Optional[str], default_tag: str) -> Keypair:
    return Keypair.from_seed((seed or default_tag).encode())


def _pipeline(model: str, perturb: bool, device, seed: int = 0, ckpt: str = ""):
    """``model``: a registry name (seeded random weights, the reference's) or
    a diffusers checkpoint directory. ``ckpt``, an orbax directory the
    reference's ``save_params`` wrote, gives the weights instead (and then
    ``perturb`` does nothing): a registry name's modules are built empty and
    filled from it, with no draws; otherwise ``perturb`` fills the zero-init
    layers (seed 99), as every service of one deployment must."""
    from ..pipelines.text2video import resolve_pipeline
    from ..utils.testing import perturb_zero_params

    if ckpt and not os.path.isdir(model):
        from ..utils.checkpoint import load_pipeline

        return load_pipeline(model, ckpt, device)
    pipe = resolve_pipeline(model, seed=seed, device=device)
    if ckpt:
        from ..utils.checkpoint import load_params

        load_params(ckpt, like=pipe)
    elif perturb:
        perturb_zero_params(pipe, seed=99)
    return pipe


def _metrics(metrics: dict, device) -> dict:
    """A role's metrics, with this process's kernel launches and, on the
    card, its device memory (bytes allocated now, at most, and reserved)."""
    out = {**metrics, "kernel_launches": launch_counts()}
    if device.type == "cuda":
        import torch

        out["device_memory"] = {"allocated": torch.cuda.memory_allocated(device),
                                "max_allocated": torch.cuda.max_memory_allocated(device),
                                "reserved": torch.cuda.memory_reserved(device)}
    return out


def _mesh_follower(rank: int, world: int, init_method: str, shape, args) -> None:
    """Rank ``rank`` of a miner's mesh: the service's pipeline and engine,
    following rank 0's generations until the service ends."""
    import torch

    from ..parallel.mesh import init_process_group, make_mesh
    from ..verify.spotcheck import StepEngine

    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
    pipe = _pipeline(args.model, args.perturb, device, ckpt=args.params_ckpt)
    init_process_group(init_method, world, rank, device)
    StepEngine(pipe, mesh=make_mesh(shape, device=device),
               strategy=args.mesh_strategy or "fsdp").follow()


def build_miner(args, pipe, kp, registry) -> Miner:
    """The service's miner: with --mesh, rank 0 of a process group over
    that mesh (the other ranks started here, as daemons); with
    --mesh-strategy alone, that strategy's one-device program."""
    mcfg = MinerConfig(spool_dir=args.spool_dir) if args.spool_dir else None
    mesh, strategy = None, args.mesh_strategy or None
    if args.mesh:
        import multiprocessing

        import numpy as np

        from ..parallel.mesh import free_port, init_process_group, make_mesh

        shape = tuple(int(x) for x in args.mesh.split(","))
        world = int(np.prod(shape))
        init = f"tcp://127.0.0.1:{free_port()}"
        ctx = multiprocessing.get_context("spawn")
        for r in range(1, world):
            ctx.Process(target=_mesh_follower, args=(r, world, init, shape, args),
                        daemon=True).start()
        init_process_group(init, world, 0, pipe.device)
        mesh = make_mesh(shape, device=pipe.device)
        strategy = strategy or "fsdp"
    return Miner(pipe, kp, registry, mcfg, mesh=mesh, strategy=strategy)


async def run_miner(args):
    import aiohttp

    t0 = time.perf_counter()
    pipe = _pipeline(args.model, args.perturb, args.device, ckpt=args.params_ckpt)
    weights_s = time.perf_counter() - t0
    kp = _keypair(args.key_seed, f"miner-{args.port}")
    registry = Registry()
    miner = build_miner(args, pipe, kp, registry)

    runner, port = await serve_neuron(miner.handle, args.host, args.port)
    address = f"{args.host}:{port}"
    print(f"[miner] serving at {address} on {pipe.device} ({miner.platform_tag}), "
          f"pubkey {kp.public_bytes.hex()[:16]}, weights in {weights_s:.2f} s", flush=True)

    async def sync_loop():
        # register, then resync the registry snapshot every sync_interval
        async with aiohttp.ClientSession() as sess:
            while True:
                try:
                    # a fresh signature each sync: the signed timestamp bounds
                    # the replay of a captured registration
                    reg_sig, reg_ts = sign_registration(
                        kp, address, "miner", miner.platform_tag, args.stake)
                    async with sess.post(
                        f"http://{args.validator_api}/register",
                        json={"pubkey": kp.public_bytes.hex(),
                              "address": address, "role": "miner",
                              "stake": args.stake,
                              "platform": miner.platform_tag,
                              "timestamp": reg_ts,
                              "signature": reg_sig.hex()},
                    ) as r:
                        uid = (await r.json()).get("uid")
                    async with sess.get(f"http://{args.validator_api}/registry") as r:
                        snap = await r.json()
                    registry.replace_all(snap)
                    print(f"[miner] synced registry ({len(snap)} neurons), uid={uid}",
                          flush=True)
                    with open("miner_metrics.json", "w") as f:
                        json.dump(_metrics(miner.metrics, pipe.device), f)
                except Exception as e:  # the validator may not be up yet
                    print(f"[miner] sync failed: {e}", flush=True)
                await asyncio.sleep(args.sync_interval)

    task = asyncio.create_task(sync_loop())
    try:
        await asyncio.Event().wait()
    finally:
        task.cancel()
        await runner.cleanup()


def _scorer(args, vcfg: ValidatorConfig, device):
    """MD-VQS over pretrained towers where --clip-ckpt / --lpips-ckpt are
    given (the same PF / VQ / TC weights as the default scorer: switching on
    pretrained towers swaps the metric, not the reward mix); None otherwise."""
    if not (args.clip_ckpt or args.lpips_ckpt):
        return None
    from ..scoring.clip_score import CLIPScorer
    from ..scoring.mdvqs import MDVQS
    from ..utils.convert import load_clip_scorer, load_lpips

    clip = (load_clip_scorer(args.clip_ckpt, device=device) if args.clip_ckpt
            else CLIPScorer.build(device=device))
    lp = load_lpips(args.lpips_ckpt, device=device) if args.lpips_ckpt else None
    print(f"[validator] MD-VQS scorers: clip={args.clip_ckpt or 'builtin'} "
          f"lpips={args.lpips_ckpt or 'proxy'}", flush=True)
    return MDVQS(clip, alpha=vcfg.mdvqs_alpha, beta=vcfg.mdvqs_beta,
                 gamma=vcfg.mdvqs_gamma, lpips_metric=lp)


async def run_validator(args, on_serving: Optional[Callable[[int], None]] = None):
    """The validator service; ``on_serving(port)`` is called once the REST
    API listens (``--api-port 0`` picks a free port)."""
    t0 = time.perf_counter()
    pipe = _pipeline(args.model, args.perturb, args.device, ckpt=args.params_ckpt)
    weights_s = time.perf_counter() - t0
    kp = _keypair(args.key_seed, "validator")
    registry = Registry()
    ledger = Ledger()
    listener = DepositListener(ledger, poll_interval_s=args.poll_interval,
                               stuck_timeout_s=args.stuck_timeout)
    transport = HttpTransport()
    vcfg = ValidatorConfig(
        sample_size=args.sample_size, num_checkpoints=args.num_checkpoints,
        width=args.width, height=args.height, num_frames=args.frames,
        num_steps=args.steps, results_dir=args.results_dir)
    validator = Validator(pipe, kp, registry, transport, ledger, vcfg,
                          scorer=_scorer(args, vcfg, pipe.device))
    validator.register(f"{args.host}:{args.api_port}", stake=10**9)

    listener.start()
    app = create_app(ledger, listener, registry, results_dir=args.results_dir)
    app["scorebook"] = validator.scores  # the /weights endpoint
    runner, port = await serve_api(app, args.host, args.api_port)
    print(f"[validator] REST API at {args.host}:{port} on {pipe.device} "
          f"({validator.engine.platform_tag}); round loop running; weights in "
          f"{weights_s:.2f} s", flush=True)
    if on_serving is not None:
        on_serving(port)

    state_path = os.path.join(args.results_dir, "validator_state.npz")
    os.makedirs(args.results_dir, exist_ok=True)
    if args.resume and os.path.exists(state_path):
        validator.scores.load(state_path)
        print(f"[validator] resumed scores for {len(validator.scores.scores)} miners",
              flush=True)

    # up to --concurrency rounds in flight. A request is claimed (pending ->
    # processing, under the listener's lock) only once a slot is free, so
    # queued requests stay 'pending' and the stuck-request refund can still
    # reach them.
    sem = asyncio.Semaphore(max(1, args.concurrency))
    tasks: dict = {}  # rid -> task (strong references)

    async def one_round(rid, prompt):
        try:
            print(f"[validator] round for {rid}: {prompt[:60]!r}", flush=True)
            try:
                report = await validator.run_round(rid, prompt)
                ok = any(not d.get("cheat") and d["score"] > 0
                         for d in report.get("miners", {}).values())
                validator.scores.save(state_path)
                with open(os.path.join(args.results_dir,
                                       "validator_metrics.json"), "w") as f:
                    json.dump(_metrics(validator.metrics, pipe.device), f)
                listener.set_status(rid, "completed" if ok else "failed")
                print(f"[validator] round for {rid}: "
                      f"{'completed' if ok else 'failed'}", flush=True)
            except Exception as e:
                print(f"[validator] round failed: {type(e).__name__}: {e}", flush=True)
                listener.set_status(rid, "failed")
        finally:
            tasks.pop(rid, None)
            sem.release()

    try:
        while True:
            await sem.acquire()
            claimed = listener.claim_next_ready()
            if claimed is None:
                sem.release()
                await asyncio.sleep(args.poll_interval)
                continue
            rid, prompt = claimed
            tasks[rid] = asyncio.create_task(one_round(rid, prompt))
    finally:
        pending = list(tasks.values())
        if pending:  # let rounds in flight finish: the miners did the work
            await asyncio.gather(*pending, return_exceptions=True)
        listener.stop()
        await transport.close()
        await runner.cleanup()


def _device_args(p: argparse.ArgumentParser, top: bool) -> None:
    # on the top-level parser and on each role's, so that both
    # `--cpu validator` and `validator --cpu` work; a role's parser leaves
    # the top level's value alone unless given
    keep = {} if top else {"default": argparse.SUPPRESS}
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu",
                   **keep)
    p.add_argument("--device", help="cuda (the default) or cpu",
                   **(keep or {"default": "cuda"}))


def build_parser():
    ap = argparse.ArgumentParser(prog="python -m dvdx_tpu_torch.network.services",
                                 description="dvdx network services")
    _device_args(ap, top=True)
    sub = ap.add_subparsers(dest="role", required=True)

    m = sub.add_parser("miner")
    _device_args(m, top=False)
    m.add_argument("--host", default="127.0.0.1")
    m.add_argument("--port", type=int, default=8201)
    m.add_argument("--validator-api", default="127.0.0.1:8100")
    m.add_argument("--model", default="zeroscope-tiny")
    m.add_argument("--perturb", action="store_true")
    m.add_argument("--key-seed", default=None)
    m.add_argument("--stake", type=int, default=10_000)
    m.add_argument("--sync-interval", type=float, default=30.0)
    m.add_argument("--spool-dir", default="miner_spool",
                   help="disk spool for reveal-able traces ('' disables)")
    m.add_argument("--params-ckpt", default="",
                   help="orbax directory of shared weights (the reference's save_params); "
                        "replaces --perturb")
    m.add_argument("--mesh", default="",
                   help="data,model,seq mesh shape (e.g. 1,2,1): PoI generation over "
                        "that many ranks, started by this service")
    m.add_argument("--mesh-strategy", default="",
                   help="the strategy of --mesh (default fsdp), or a chunked one "
                        "(chunk, hybrid, hybrid_ctx) alone")

    v = sub.add_parser("validator")
    _device_args(v, top=False)
    v.add_argument("--host", default="127.0.0.1")
    v.add_argument("--api-port", type=int, default=8100)
    v.add_argument("--model", default="zeroscope-tiny")
    v.add_argument("--perturb", action="store_true")
    v.add_argument("--key-seed", default=None)
    v.add_argument("--sample-size", type=int, default=3)
    v.add_argument("--num-checkpoints", type=int, default=3)
    v.add_argument("--width", type=int, default=128)
    v.add_argument("--height", type=int, default=128)
    v.add_argument("--frames", type=int, default=3)
    v.add_argument("--steps", type=int, default=8)
    v.add_argument("--lpips-ckpt", default="",
                   help="lpips(alex) checkpoint (.pth / .safetensors): the "
                        "pretrained perceptual VQ term")
    v.add_argument("--clip-ckpt", default="",
                   help="transformers CLIPModel checkpoint dir: pretrained "
                        "MD-VQS scoring (utils.convert.load_clip_scorer)")
    v.add_argument("--poll-interval", type=float, default=2.0)
    v.add_argument("--concurrency", type=int, default=1)
    v.add_argument("--stuck-timeout", type=float, default=600.0)
    v.add_argument("--results-dir", default="generated_videos")
    v.add_argument("--resume", action="store_true")
    v.add_argument("--params-ckpt", default="",
                   help="orbax directory of shared weights (the reference's save_params); "
                        "replaces --perturb")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """The parsed arguments, ``--cpu`` folded into ``device``."""
    args = build_parser().parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.params_ckpt:
        try:
            import tensorstore  # noqa: F401
        except ImportError as e:
            print(f"{args.role}: --params-ckpt reads orbax checkpoints through the "
                  f"tensorstore module, which does not import here ({e})", file=sys.stderr)
            return 2
    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"{args.role}: no CUDA device; pass --device cpu (or --cpu) to run on "
              "the CPU", file=sys.stderr)
        return 2
    coro = run_miner(args) if args.role == "miner" else run_validator(args)
    try:
        asyncio.run(coro)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
