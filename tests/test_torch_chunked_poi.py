"""Chunked and mesh Proof of Inference on the port: the twins of
``tests/test_chunked_poi.py`` and ``tests/test_mesh_poi.py``, on
zeroscope-tiny (float32, the reference's perturbed weights bridged in),
and rounds across the implementations with a chunked (hybrid_ctx) miner.

A chunked miner's leaves are the chunk-stacked (n, L, h, w, C) latents of
the plan its committed ``num_chunks`` fixes; the validator rebuilds that
plan's step program, derives the base chunk stack and the CCI context with
the same ``chunk_prep_fn``, and blends the final chunk stack before the
video binding. Mesh miners run on 2 gloo ranks (rank 0 leads, rank 1
follows; ``tests/torch_dist_workers.py``); their traces verify on a
one-device validator. Tolerances: one device, same program: bitwise; a
mesh trace re-executed on one device: the JAX twins' (fsdp 5e-3, hybrid_ctx
5e-2 of the 1e-1 regime); across the implementations the validator's
cross-platform atol 5e-2, where an honest miner may be refused only as
ROADMAP §3.1 says (one bf16 ulp of z at |z| >= 8, ``honest_or_known_refusal``).
"""

import asyncio
import functools

import jax
import numpy as np
import pytest
import torch

from dvdx_tpu.network.miner import Miner as JMiner
from dvdx_tpu.network.mock import LazyMiner as JLazyMiner
from dvdx_tpu.pipelines.text2video import _save_flat_npz
from dvdx_tpu_torch.network.miner import Miner
from dvdx_tpu_torch.network.mock import LazyMiner, build_mock_network
from dvdx_tpu_torch.network.validator import MAX_CHUNK_ENGINES, ValidatorConfig
from dvdx_tpu_torch.parallel.mesh import run_ranks, single_device_mesh
from dvdx_tpu_torch.parallel.strategies import get_strategy
from dvdx_tpu_torch.verify.spotcheck import StepEngine, verify_revealed_steps
from tests import torch_dist_workers as workers
from tests.test_torch_network_rounds import (ATOL_CROSS, BF16_ULP_AT_8, _cross_round,
                                             tiny_port)  # noqa: F401  (fixture)

torch.set_num_threads(2)

F, H, W, T = 8, 32, 32, 3


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _cfg(tmp, **kw):
    base = dict(sample_size=1, num_checkpoints=2, num_frames=F, width=W, height=H,
                num_steps=T, ping_timeout_s=30, results_dir=str(tmp))
    base.update(kw)
    return ValidatorConfig(**base)


def _one(report):
    return next(iter(report["miners"].values()))


@pytest.fixture(scope="module")
def weights(tiny_pipeline, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("w") / "tiny.npz")
    _save_flat_npz(path, jax.tree.map(np.asarray, tiny_pipeline.params))
    return path


# --- one device (tests/test_chunked_poi.py) ---------------------------------


def test_single_device_chunked_trace_is_bitwise(tiny_port):
    eng = StepEngine(tiny_port, strategy=get_strategy("hybrid_ctx", num_chunks=3))
    assert eng.platform_tag == "torch-cpu:hybrid_ctx"
    video, zs, epss, ts = eng.generate_recorded("chunk trace", seed=7, num_frames=F,
                                                height=H, width=W, num_steps=T,
                                                guidance_scale=7.5)
    plan = eng.chunk_plan(F)
    assert video.shape == (F, H, W, 3)
    assert zs.shape == (T, plan.num_chunks, plan.chunk_len, 16, 16, 4)
    ver = StepEngine(tiny_port, strategy=get_strategy("hybrid_ctx", num_chunks=3))
    ctx = ver.context_latent(7, F, H, W)
    leaves = {i: (int(ts[i]), zs[i], epss[i]) for i in range(T)}
    results, _ = verify_revealed_steps(ver, "chunk trace", "", leaves, [0, 1, 2], T, 7.5,
                                       same_platform=True, atol=0.0, ctx=ctx)
    assert all(r.passed and r.bitwise for r in results.values()), results
    assert torch.equal(ver.base_latent(7, F, H, W).view(torch.int16), zs[0].view(torch.int16))
    ok, err = ver.verify_video_binding(video, leaves[T - 1], T - 1, T, 7.5, "chunk trace",
                                       frame_indices=[0, F - 1], num_frames=F)
    assert ok, err


def test_precond_engine_refused(tiny_port):
    with pytest.raises(ValueError, match="precond"):
        StepEngine(tiny_port, strategy="precond")


def test_chunked_pin_with_canonical_trace_fails(tiny_port, tmp_path):
    """A miner pinned torch-cpu:chunk that ran the plain program commits
    num_chunks 0 and full-latent leaves: refused at chunk_plan."""
    net = build_mock_network(n_miners=1, pipeline=tiny_port, validator_config=_cfg(tmp_path))
    info = net.registry.by_pubkey(net.miners[0].pubkey)
    info.platform = "torch-cpu:chunk"
    miner = net.miners[0]
    orig = miner._generate_with_proof

    def claimed(req):
        resp = orig(req)
        resp.platform = info.platform
        return resp

    miner._generate_with_proof = claimed
    d = _one(_run(net.run_request("chunk-req-4", "a mispinned miner")))
    assert d.get("failed_check") in ("chunk_plan", "latent_shape"), d
    assert d["score"] == 0.0


def test_validator_chunk_engines_are_bounded(tiny_port, tmp_path):
    net = build_mock_network(n_miners=1, pipeline=tiny_port, validator_config=_cfg(tmp_path))
    val = net.validator
    first = val._chunk_engine("hybrid_ctx", 2)
    assert val._chunk_engine("hybrid_ctx", 2) is first
    for n in range(3, 3 + 2 * MAX_CHUNK_ENGINES):
        val._chunk_engine("chunk", n)
    assert len(val._chunk_engines) == MAX_CHUNK_ENGINES
    assert ("hybrid_ctx", 2) not in val._chunk_engines


def test_mesh_engine_rejects_precond_strategy(tiny_port):
    with pytest.raises(ValueError, match="precond"):
        StepEngine(tiny_port, mesh=single_device_mesh("cpu"), strategy="precond")


def test_single_strategy_on_a_mesh_is_the_plain_engine(tiny_port):
    """The JAX engine raises AttributeError here (ADVICE.md); the port's is
    the plain program."""
    eng = StepEngine(tiny_port, mesh=single_device_mesh("cpu"), strategy="single")
    assert eng.strategy is None and eng.platform_tag == "torch-cpu"


@pytest.mark.parametrize("world", [1, 2])
def test_mesh_engine_shards_its_pipeline_in_place(weights, tmp_path, world):
    """No second copy of the weights behind a mesh miner: on a model axis of
    ``world`` gloo ranks the engine shards the pipeline it is given, which
    then holds exactly ``sharded_size_per_device``'s bytes on each rank, and
    ``close`` restores it bit for bit, each leaf in a storage of its own (at
    one rank the gathered unit buffer would otherwise stay alive behind the
    leaves that view it); the mock network copies the pipeline per mesh
    miner only."""
    outs = run_ranks(workers.in_place_shard, world, args=("zeroscope-tiny", weights),
                     device="cpu", timeout_s=60, workdir=str(tmp_path))
    for out in outs:
        assert out["same_pipeline"] and out["sharded"] and out["restored"], out
        assert out["own_storage"], out
        assert out["held_bytes"] == out["expected_bytes"] <= out["whole_bytes"], out
        assert (out["held_bytes"] < out["whole_bytes"]) == (world > 1), out
        assert out["miner_copies"] and out["miners_sharded"] and out["validator_whole"], out


# --- mesh traces and rounds over 2 gloo ranks ----------------------------------

TRACES = [("fsdp", (1, 2, 1), {}, dict(num_frames=2, height=32, width=32, num_steps=3)),
          ("hybrid_ctx", (1, 1, 2), {"num_chunks": 4},
           dict(num_frames=F, height=H, width=W, num_steps=T))]


@pytest.fixture(scope="module")
def mesh_traces(weights, tmp_path_factory):
    return run_ranks(workers.mesh_traces, 2, args=("zeroscope-tiny", weights, TRACES),
                     device="cpu", timeout_s=60,
                     workdir=str(tmp_path_factory.mktemp("traces")))[0]


def test_mesh_engine_trace_verifies_on_single_device(tiny_port, mesh_traces):
    video, zs, epss, ts, tag, _ = mesh_traces[0]
    assert tag == "torch-cpu:fsdp"
    assert video.shape == (2, 32, 32, 3) and zs.shape == (3, 2, 16, 16, 4)
    single = StepEngine(tiny_port)
    leaves = {i: (int(ts[i]), zs[i], epss[i]) for i in range(3)}
    results, _ = verify_revealed_steps(single, workers.PROMPT, "", leaves, [0, 1, 2], 3,
                                       7.5, same_platform=False, atol=5e-3)
    assert all(r.passed for r in results.values()), results
    base = single.base_latent(7, 2, 32, 32)
    assert torch.equal(base.view(torch.int16), zs[0].view(torch.int16))


def test_mesh_chunked_trace_verifies_single_device(tiny_port, mesh_traces):
    video, zs, epss, ts, tag, chunks = mesh_traces[1]
    assert tag == "torch-cpu:hybrid_ctx" and chunks == 4
    ver = StepEngine(tiny_port, strategy=get_strategy("hybrid_ctx", num_chunks=4))
    ctx = ver.context_latent(7, F, H, W)
    leaves = {i: (int(ts[i]), zs[i], epss[i]) for i in range(T)}
    results, _ = verify_revealed_steps(ver, workers.PROMPT, "", leaves, [0, 1, 2], T, 7.5,
                                       same_platform=False, atol=1e-1, ctx=ctx)
    assert all(r.passed for r in results.values()), results
    worst = max(max(r.max_eps_err, r.max_z_err) for r in results.values())
    print(f"mesh hybrid_ctx trace on one device: max err {worst:.3g}")  # pytest -rP
    assert worst < 5e-2, worst


ROUNDS = [("chunked", (1, 1, 2), "hybrid_ctx", [], {"num_frames": F}, False),
          ("chunked_lazy", (1, 1, 2), "hybrid_ctx", ["lazy"],
           {"num_frames": F, "num_checkpoints": 3}, False),
          ("chunked_lie", (1, 1, 2), "hybrid_ctx", [], {"num_frames": F}, True),
          ("fsdp", (1, 2, 1), "fsdp", [], {"num_frames": 2}, False),
          ("cp_exact", (1, 1, 2), "cp_exact", [], {"num_frames": 4}, False),
          ("fsdp_lazy", (1, 2, 1), "fsdp", ["lazy"],
           {"num_frames": 2, "num_checkpoints": 3}, False)]


@pytest.fixture(scope="module")
def mesh_rounds(weights, tmp_path_factory):
    return run_ranks(workers.mesh_rounds, 2, args=("zeroscope-tiny", weights, ROUNDS),
                     device="cpu", timeout_s=120,
                     workdir=str(tmp_path_factory.mktemp("rounds")))[0]


def test_chunked_miner_full_round(mesh_rounds):
    report, pin, status = mesh_rounds["chunked"]
    assert pin == "torch-cpu:hybrid_ctx"
    d = _one(report)
    for check in ("base_noise", "reexecution", "video_binding"):
        assert d["checks"].get(check), d
    assert d["verify_engine"] == "hybrid_ctx"
    assert d["regime_atol"] == pytest.approx(1e-1)
    assert d["score"] > 0.0 and not d.get("cheat", False)
    assert status == "distributed"


def test_lazy_chunked_miner_detected(mesh_rounds):
    d = _one(mesh_rounds["chunked_lazy"][0])
    assert d.get("cheat", False) is True and d["failed_check"] == "reexecution", d
    assert d["score"] == 0.0


def test_num_chunks_lie_fails_shape_crosscheck(mesh_rounds):
    d = _one(mesh_rounds["chunked_lie"][0])
    assert d.get("failed_check") == "latent_shape", d
    assert d["score"] == 0.0


def test_fsdp_mesh_miner_full_round(mesh_rounds):
    report, pin, status = mesh_rounds["fsdp"]
    assert pin == "torch-cpu:fsdp"
    d = _one(report)
    assert d["checks"]["signature"] and d["checks"]["merkle"], d
    assert d["checks"]["reexecution"], d
    assert d["same_platform"] is False and d["regime_atol"] == pytest.approx(2e-2)
    assert d["score"] > 0.0 and not d.get("cheat", False)
    assert status == "distributed"


def test_cp_exact_mesh_miner_full_round(mesh_rounds):
    report, pin, _ = mesh_rounds["cp_exact"]
    assert pin == "torch-cpu:cp_exact"
    d = _one(report)
    assert d["checks"]["reexecution"], d
    assert d["same_platform"] is False
    assert d["score"] > 0.0 and not d.get("cheat", False)


def test_lazy_mesh_miner_detected_in_tolerance_mode(mesh_rounds):
    d = _one(mesh_rounds["fsdp_lazy"][0])
    assert d.get("cheat", False) is True, d
    assert d["score"] == 0.0


# --- across the implementations -----------------------------------------------


def _chunked_refusal_or_pass(r) -> bool:
    """honest_or_known_refusal for a chunked miner: True when it passed;
    False when refused at ``reexecution`` on z_{t+1} by one bf16 ulp at |z|
    >= 8 (ROADMAP §3.1), everything before it passed. Any other refusal
    fails."""
    d = r.report["miners"]["0"]
    if d.get("failed_check") != "reexecution":
        assert not d.get("cheat") and "failed_check" not in d, d
        return True
    assert d["reason"] == "z_{t+1} re-derivation mismatch" \
        and d["z_err"] == BF16_ULP_AT_8 and d["eps_err"] < ATOL_CROSS, d
    assert all(d["checks"][c] for c in ("echo", "identity", "timesteps", "signature",
                                        "authenticity", "merkle", "base_noise")), d
    print(f"refused by the cross-platform bound (ROADMAP §3.1): {d}")  # pytest -rP
    return False


@pytest.mark.parametrize("torch_validator", [True, False])
def test_chunked_round_across_implementations(tiny_port, tiny_pipeline, torch_validator,
                                              tmp_path):
    """A hybrid_ctx miner of one package (honest, then lazy) behind the
    other package's validator: both read the pin as another backend's
    strategy (the cross-platform atol 5e-2) and re-execute the committed
    chunk plan."""
    if torch_validator:
        classes = (functools.partial(JMiner, strategy="hybrid_ctx"),
                   functools.partial(JLazyMiner, strategy="hybrid_ctx"))
        miner_pipe, val_pipe, pin = tiny_pipeline, tiny_port, "cpu:hybrid_ctx"
    else:
        classes = (functools.partial(Miner, strategy="hybrid_ctx"),
                   functools.partial(LazyMiner, strategy="hybrid_ctx"))
        miner_pipe, val_pipe, pin = tiny_port, tiny_pipeline, "torch-cpu:hybrid_ctx"
    r = _cross_round(miner_pipe, val_pipe, torch_validator, tmp_path, "xc-1",
                     miner_classes=classes, num_frames=F)
    assert r.miners[0].platform_tag == pin
    d = r.report["miners"]["0"]
    assert d["same_platform"] is False and d["regime_atol"] == ATOL_CROSS, d
    if _chunked_refusal_or_pass(r):
        assert d["verify_engine"] == "hybrid_ctx" and d["checks"]["video_binding"]
        assert d["score"] > 0.0
    lazy = r.report["miners"]["1"]
    assert lazy["failed_check"] == "reexecution" and lazy["cheat"] is True, lazy
