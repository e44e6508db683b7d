"""Rank functions of the port's multi-rank CPU tests.

``dvdx_tpu_torch.parallel.mesh.run_ranks`` starts each rank as a fresh
process that imports the function it runs; this module imports neither JAX
nor the JAX package, so a rank starts in the time torch takes to import.
Every function takes (rank, world_size, device, *args) and returns what the
test holds (tensors, numbers, reports), saved by ``run_ranks``. Weights come
from a flat npz of the JAX package's perturbed parameter tree
(``utils.bridge.load_flat_npz``), so the ranks and the JAX reference run the
same model.
"""

from __future__ import annotations

import asyncio
import tempfile

import torch

GEO = dict(num_frames=8, height=16, width=16, num_steps=2)
PROMPT = "a red ball"


def _pipe(model: str, weights: str):
    from dvdx_tpu_torch.pipelines.text2video import build_pipeline
    from dvdx_tpu_torch.utils.bridge import load_flat_npz, load_pipeline_params

    torch.set_num_threads(1)
    return load_pipeline_params(build_pipeline(model, device="cpu"), load_flat_npz(weights))


def _ids(pipe, prompt: str = PROMPT):
    return torch.from_numpy(pipe.tokenize(["", prompt])).long()


def presets(rank, world, device, model, weights, cases, geo=GEO, prompt=PROMPT, seed=5):
    """Each (name, mesh shape, overrides) of ``cases`` through
    ``build_runner`` on the mesh at ``geo``, and the one-device program
    beside it: {name: frames}, {name + "@1": frames on a single_device_mesh}
    (a chunked strategy there with the mesh's chunk count)."""
    from dvdx_tpu_torch.ops import rng
    from dvdx_tpu_torch.parallel.chunking import auto_chunk_count
    from dvdx_tpu_torch.parallel.mesh import make_mesh, single_device_mesh
    from dvdx_tpu_torch.parallel.strategies import build_runner, get_strategy

    pipe, out = _pipe(model, weights), {}
    ids, key = _ids(pipe, prompt), rng.base_key(seed)
    for name, shape, overrides in cases:
        st = get_strategy(name, **overrides)
        if st.chunked and not st.num_chunks:  # the mesh's plan, on one device too
            st = get_strategy(name, **dict(overrides, num_chunks=auto_chunk_count(
                geo["num_frames"], shape[2])))
        one = build_runner(pipe, st, single_device_mesh("cpu"), **geo)
        out[name + "@1"] = one(ids, key)
        runner = build_runner(pipe, st, make_mesh(shape, device="cpu"), **geo)
        out[name] = runner(ids, key)
        out[name + ":gathers"] = sum(s.gathers for s in runner.shards)
        runner.close()
    return out


def attention(rank, world, device, cases):
    """Ring / Ulysses attention on this rank's block of each (algo, q, k,
    v) case (full tensors, the same on every rank), the global attention's
    block beside it, and which path impl='ring' took in an 'auto' context."""
    import dvdx_tpu_torch.ops.ring_attention as ra
    from dvdx_tpu_torch.ops.attention import multi_head_attention, ring_context
    from dvdx_tpu_torch.ops.kernels.flash_attention import flash_attention_plain
    from dvdx_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((1, 1, world), device="cpu")
    out = []
    for algo, q, k, v in cases:
        s = q.shape[1] // world
        blk = slice(rank * s, (rank + 1) * s)
        fn = ra.ring_attention if algo == "ring" else ra.ulysses_attention
        try:
            got = fn(q[:, blk], k[:, blk], v[:, blk], mesh)
        except ValueError as e:
            got = str(e)
        out.append((got, flash_attention_plain(q, k, v)[:, blk]))
    taken = {}
    for heads in (world * 2, world * 2 + 1):
        calls = []
        saved = ra.ring_attention, ra.ulysses_attention
        ra.ring_attention = lambda *a, **kw: calls.append("ring") or saved[0](*a, **kw)
        ra.ulysses_attention = lambda *a, **kw: calls.append("ulysses") or saved[1](*a, **kw)
        try:
            x = torch.randn(1, 4, heads, 8, generator=torch.Generator().manual_seed(0))
            with ring_context(mesh, "seq", algo="auto"):
                multi_head_attention(x, x, x, impl="ring")
        finally:
            ra.ring_attention, ra.ulysses_attention = saved
        taken[heads] = calls
    return out, taken


def gather_time(rank, world, device, shape):
    """``parallel.runner.measure_gather_s`` on a (1, 1, world) mesh."""
    from dvdx_tpu_torch.parallel.mesh import make_mesh
    from dvdx_tpu_torch.parallel.runner import measure_gather_s

    return measure_gather_s(make_mesh((1, 1, world), device="cpu"), shape, torch.bfloat16,
                            reps=3)


def frame_pieces(rank, world, device, x, gamma, beta, weight, bias):
    """The frame-sharded GroupNorm (moments all-reduced over the seq group)
    and the (3, 1) temporal conv with a one-frame halo, on this rank's
    frames of x (B, F, N, C), beside the one-device results' blocks."""
    import torch.nn.functional as F

    from dvdx_tpu_torch.ops.groupnorm import group_norm_act_plain, group_norm_act_sharded
    from dvdx_tpu_torch.ops.ring_attention import frame_halo
    from dvdx_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((1, 1, world), device="cpu")
    fl = x.shape[1] // world
    mine = x[:, rank * fl:(rank + 1) * fl]
    gn = group_norm_act_sharded(mine, gamma, beta, groups=4, eps=1e-5, act="silu",
                                group=mesh.group(("seq",)), group_size=world)
    gn_ref = group_norm_act_plain(x, gamma, beta, groups=4, eps=1e-5, act="silu")

    def conv(t, pad):
        return F.conv2d(t.permute(0, 3, 1, 2), weight, bias, padding=pad).permute(0, 2, 3, 1)

    halo = conv(frame_halo(mine, mesh), (0, 0))
    conv_ref = conv(x, (1, 0))
    blk = slice(rank * fl, (rank + 1) * fl)
    return gn, gn_ref[:, blk], halo, conv_ref[:, blk]


def mesh_traces(rank, world, device, model, weights, cases):
    """Recorded generations of mesh engines: each (strategy, mesh shape,
    overrides, geometry) generated on every rank (rank 0 leads, the others
    follow) -> rank 0's (video, zs, epss, ts, tag, chunks)."""
    from dvdx_tpu_torch.parallel.mesh import make_mesh
    from dvdx_tpu_torch.parallel.strategies import get_strategy
    from dvdx_tpu_torch.verify.spotcheck import StepEngine

    pipe, out = _pipe(model, weights), []
    for name, shape, overrides, geo in cases:
        eng = StepEngine(pipe, mesh=make_mesh(shape, device="cpu"),
                         strategy=get_strategy(name, **overrides))
        if rank == 0:
            video, zs, epss, ts = eng.generate_recorded(PROMPT, seed=7, guidance_scale=7.5,
                                                        **geo)
            plan = eng.chunk_plan(geo["num_frames"])
            out.append((video, zs, epss, ts, eng.platform_tag,
                        plan.num_chunks if plan else 0))
            eng.release_followers()
        else:
            eng.follow()
        eng.close()
    return out


def mesh_rounds(rank, world, device, model, weights, cases):
    """Network rounds of mesh miners: for each (tag, mesh shape, strategy,
    adversaries, validator overrides, lie) rank 0 runs build_mock_network
    with the mesh (a 'lie' adds one to the committed num_chunks) and one
    request; the other ranks follow its miners' generations. -> rank 0's
    {tag: (report, pin)}."""
    from dvdx_tpu_torch.network.mock import build_mock_network
    from dvdx_tpu_torch.network.validator import ValidatorConfig
    from dvdx_tpu_torch.parallel.mesh import make_mesh
    from dvdx_tpu_torch.verify.spotcheck import StepEngine

    pipe, out = _pipe(model, weights), {}
    for tag, shape, strategy, adversaries, vcfg, lie in cases:
        mesh = make_mesh(shape, device="cpu")
        if rank != 0:
            eng = StepEngine(pipe, mesh=mesh, strategy=strategy)
            eng.follow()
            eng.close()
            continue
        with tempfile.TemporaryDirectory() as tmp:
            cfg = ValidatorConfig(**dict(dict(sample_size=1, num_checkpoints=2, width=32,
                                              height=32, num_steps=3, ping_timeout_s=30,
                                              results_dir=tmp), **vcfg))
            net = build_mock_network(n_miners=1, adversaries=adversaries, pipeline=pipe,
                                     validator_config=cfg, mesh=mesh,
                                     mesh_strategy=strategy)
            miner = net.miners[0]
            if lie:
                orig = miner._generate_with_proof

                def tampered(req, orig=orig):
                    resp = orig(req)
                    resp.num_chunks += 1
                    return resp

                miner._generate_with_proof = tampered
            pin = net.registry.by_pubkey(miner.pubkey).platform
            loop = asyncio.new_event_loop()
            try:
                report = loop.run_until_complete(net.run_request(f"mesh-{tag}", PROMPT))
            finally:
                loop.close()
            status = net.ledger.requests[f"mesh-{tag}"].status
            miner.engine.release_followers()
            miner.engine.close()
        out[tag] = (report, pin, status)
    return out


def in_place_shard(rank, world, device, model, weights):
    """A mesh engine shards the pipeline it is given in place and gives it
    back whole; the mock network hands each mesh miner a copy and keeps the
    validator's pipeline whole."""
    from dvdx_tpu_torch.network.mock import build_mock_network
    from dvdx_tpu_torch.network.validator import ValidatorConfig
    from dvdx_tpu_torch.parallel.mesh import make_mesh
    from dvdx_tpu_torch.verify.spotcheck import StepEngine

    from dvdx_tpu_torch.parallel.sharding import sharded_size_per_device

    pipe = _pipe(model, weights)
    whole = {k: v.clone() for k, v in pipe.state_dict().items()}
    mesh = make_mesh((1, world, 1), device="cpu")
    expected = sharded_size_per_device([pipe.unet, pipe.text_encoder, pipe.vae_decoder], mesh)
    eng = StepEngine(pipe, mesh=mesh, strategy="fsdp")
    out = {"same_pipeline": eng.pipe is pipe, "sharded": pipe.unet._dvdx_sharded,
           "held_bytes": sum(p.numel() * p.element_size() for p in pipe.parameters()),
           "expected_bytes": expected,
           "whole_bytes": sum(v.numel() * v.element_size() for v in whole.values())}
    eng.close()
    out["restored"] = all(torch.equal(whole[k], v) for k, v in pipe.state_dict().items())
    # each leaf back in a storage of its own: no gathered buffer kept alive
    # (at one rank a (3, 1) temporal conv's weight, split on its trailing
    # axis of 1, would come back as a view of its unit's gathered buffer)
    from dvdx_tpu_torch.parallel.sharding import shard_module

    lin = torch.nn.Sequential(torch.nn.Sequential(torch.nn.Conv2d(128, 64, (3, 1)),
                                                  torch.nn.Conv2d(128, 64, (3, 1))))
    shard_module(lin, mesh).remove()
    out["own_storage"] = all(p.untyped_storage().nbytes() == p.numel() * p.element_size()
                             for p in list(pipe.parameters()) + list(lin.parameters()))
    with tempfile.TemporaryDirectory() as tmp:
        net = build_mock_network(n_miners=2, pipeline=pipe, mesh=mesh, mesh_strategy="fsdp",
                                 validator_config=ValidatorConfig(results_dir=tmp))
        pipes = [m.pipeline for m in net.miners]
        out["miner_copies"] = pipes[0] is not pipes[1] and all(p is not pipe for p in pipes)
        out["miners_sharded"] = all(p.unet._dvdx_sharded for p in pipes)
        out["validator_whole"] = (net.validator.pipeline is pipe
                                  and not getattr(pipe.unet, "_dvdx_sharded", False))
        for m in net.miners:
            m.engine.close()
    return out


def cp_unet_call(rank, world, device, model, weights, z, t, hidden, algo="ring"):
    """One UNet call of the exact-CP program: this rank's frames of the
    float32 latents z (B, F, h, w, C) inside ``ring_context`` on a (1, 1,
    world) mesh, the ranks' eps gathered over the frames; and the
    one-device call on the whole z beside it."""
    from dvdx_tpu_torch.ops.attention import ring_context
    from dvdx_tpu_torch.parallel.mesh import make_mesh
    from dvdx_tpu_torch.parallel.strategies import _gather_cat

    pipe = _pipe(model, weights)
    mesh = make_mesh((1, 1, world), device="cpu")
    fl = z.shape[1] // world
    off = rank * fl
    with torch.inference_mode():
        with ring_context(mesh, "seq", algo=algo):
            eps = pipe.unet(z[:, off:off + fl], t, hidden, torch.arange(off, off + fl))
        return _gather_cat(eps, mesh, ("seq",), dim=1), pipe.unet(z, t, hidden)
