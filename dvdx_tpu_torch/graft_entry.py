"""Entry points of the port: one step at the north-star geometry, and the
multi-rank dry run.

Counterpart of the repository's ``__graft_entry__.py`` (which drives the
JAX package):

* ``entry()`` -> (fn, example_args): one classifier-free-guided DDIM step
  of zeroscope-v2-576w's UNet3D at 16 frames of 576x320 (latents 16 x 40 x
  72 x 4), on the card, with the registry's seed-0 weights;
* ``dryrun_multichip(n, device)``: n ranks (``"cuda"``: NCCL, rank r on
  card r; ``"cpu"``: gloo) run perturbed zeroscope-tiny (16 frames of 32x32, 2 steps) through fsdp, cp_exact,
  cp_ulysses and hybrid_ctx, and print one row per check: fsdp, cp_exact
  and cp_ulysses against the single-device video, hybrid_ctx against the
  identical chunked program on one device. Each is held to the limit the
  JAX dry run asserts (LIMITS) and printed beside that run's reading in
  ``MULTICHIP_r05.json`` (R05, at 8 devices). The port's ring merges its
  statistics in another order than the JAX ring: cp_exact is 3.2e-3 from
  single at 2 ranks, and cp_ulysses takes the ring wherever the heads do
  not split over the ranks.

  python -m dvdx_tpu_torch.graft_entry [--ranks N] [--device cuda|cpu] [--skip-entry]
"""

from __future__ import annotations

import argparse
import sys

import torch

# the limits __graft_entry__.dryrun_multichip asserts, and its readings at 8
# devices (MULTICHIP_r05.json)
LIMITS = {"fsdp": 5e-3, "cp_exact": 5e-3, "cp_ulysses": 5e-3, "hybrid_ctx": 1e-2}
R05 = {"fsdp": 3.24e-3, "cp_exact": 1.40e-3, "cp_ulysses": 3.72e-4, "hybrid_ctx": 1.94e-3}
GEO = dict(num_frames=16, height=32, width=32, num_steps=2)
PROMPT, SEED = "dry run", 0


def entry(device="cuda"):
    """(fn, (lat, ctx, step_index)): fn(lat, ctx, step_index) -> the next
    latent (1, 16, 40, 72, 4) bf16, from the batched [uncond, cond] UNet
    call and the DDIM update (guidance 7.5)."""
    from .ops.scheduler import make_ddim_schedule
    from .pipelines.text2video import build_pipeline, cfg_denoise_step

    pipe = build_pipeline("zeroscope-v2-576w", seed=0, device=device)
    sched = make_ddim_schedule(25)
    dev = pipe.device
    lat = torch.zeros((1, 16, 40, 72, 4), dtype=torch.bfloat16, device=dev)
    ctx = torch.zeros((2, 77, pipe.spec.unet.cross_attention_dim), dtype=torch.bfloat16,
                      device=dev)

    @torch.inference_mode()
    def fn(lat, ctx, step_index):
        return cfg_denoise_step(pipe.unet, sched, lat, int(step_index), ctx[1:], ctx[:1],
                                7.5)[0]

    return fn, (lat, ctx, 0)


def _mesh_factors(n: int):
    """The JAX dry run's (data, model, seq) factorisation of n ranks."""
    data = 2 if n % 2 == 0 and n >= 4 else 1
    rest = n // data
    model = 1
    while rest % (model * 2) == 0 and (model * 2) ** 2 <= rest:
        model *= 2
    return data, model, rest // model


def _dryrun_rank(rank, world, device):
    """One rank of ``dryrun_multichip``: {check: (mesh, max_abs_err)}."""
    from .ops import rng
    from .parallel.mesh import make_mesh, single_device_mesh
    from .parallel.strategies import build_runner, get_strategy
    from .pipelines.text2video import build_pipeline
    from .utils.testing import perturb_zero_params

    torch.set_num_threads(1)
    pipe = perturb_zero_params(build_pipeline("zeroscope-tiny", seed=0, device=device), seed=99)
    ids = torch.from_numpy(pipe.tokenize(["", PROMPT])).long().to(pipe.device)
    key = rng.base_key(SEED)

    def run(strategy, shape, **kw):
        mesh = (single_device_mesh(pipe.device) if shape is None
                else make_mesh(shape, device=pipe.device))
        runner = build_runner(pipe, strategy, mesh, **GEO, **kw)
        try:
            return runner(ids, key).float().cpu()
        finally:
            runner.close()

    single = run(get_strategy("single"), None)
    rows = {}
    for name, shape in (("fsdp", (1, world, 1)), ("cp_exact", (1, 1, world)),
                        ("cp_ulysses", (1, 1, world))):
        if GEO["num_frames"] % shape[2]:
            continue  # the frames do not split over this many ranks
        st = get_strategy(name) if name == "fsdp" else get_strategy(name, shard_params=False)
        err = float((run(st, shape) - single).abs().max())
        rows[name] = (shape, err)
    shape = _mesh_factors(world)
    batch = 2 * shape[0] if shape[0] > 1 else 1
    st = get_strategy("hybrid_ctx", num_chunks=4)
    err = float((run(st, shape, batch_size=batch) - run(st, None, batch_size=batch))
                .abs().max())
    rows["hybrid_ctx"] = (shape, err)
    return rows


def dryrun_multichip(n_ranks: int = 2, device: str = "cuda", timeout_s: float = 600.0) -> dict:
    """Run the checks on ``n_ranks`` ranks on ``device``; print a row per check
    and raise AssertionError where one exceeds its limit or the ranks
    disagree. Returns rank 0's rows {check: (mesh, max_abs_err)}."""
    from .parallel.mesh import run_ranks

    results = run_ranks(_dryrun_rank, n_ranks, device=device, timeout_s=timeout_s)
    rows = results[0]
    failed = []
    for name, (shape, err) in rows.items():
        agree = all(r[name][1] == err for r in results[1:])
        ok = err <= LIMITS[name] and agree
        print(f"{name:<11} mesh={shape} max_abs_err={err:.3e} limit={LIMITS[name]:.0e} "
              f"r05={R05[name]:.2e} ranks_agree={agree} {'ok' if ok else 'FAILED'}",
              flush=True)
        if not ok:
            failed.append(name)
    if failed:
        raise AssertionError(f"dryrun_multichip: {failed} outside their limits")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dvdx_tpu_torch.graft_entry")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the dry run's ranks: cuda (NCCL, rank r on card r) or cpu (gloo)")
    ap.add_argument("--skip-entry", action="store_true",
                    help="only the dry run (entry() needs the card)")
    args = ap.parse_args(argv)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if args.device == "cuda" and cards < args.ranks:
        print(f"dry run: {args.ranks} NCCL ranks need {args.ranks} cards, {cards} here "
              "(pass --device cpu for gloo ranks)", file=sys.stderr)
        return 2
    if not args.skip_entry:
        if not torch.cuda.is_available():
            print("entry: no CUDA device (pass --skip-entry for the dry run alone)",
                  file=sys.stderr)
            return 2
        fn, example = entry()
        out = fn(*example)
        torch.cuda.synchronize()
        print(f"entry OK: {tuple(out.shape)} {out.dtype} finite={bool(out.isfinite().all())}")
    dryrun_multichip(args.ranks, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
