"""The port's distribution pillar against the JAX package's
(``dvdx_tpu/parallel``), on the CPU.

* Chunking: plans, chunk counts and bounds exactly; the float32 blend and
  split / stitch within 1e-6 of JAX's segment-sum; the boundary metrics of
  ``scoring/temporal.py`` exactly.
* Sharding: ``_leaf_spec`` and ``sharded_size_per_device`` exactly (the
  port's leaves are the JAX tree's, transposed where the bridge transposes).
* Presets: the eight names and fields equal JAX's.
* One process: chunk, hybrid_ctx and precond through ``build_runner`` on
  zeroscope-tiny-hf (float32) against JAX's ``build_runner`` on a (1, 1, 1)
  mesh, decoded frames within 2e-2 (measured 4.4e-3 to 1.1e-2 at 16 frames:
  the latents are bf16, so a 1e-6 difference in the float32 UNet can flip one
  bf16 rounding of a step; ``test_torch_pipeline.py`` states the same for
  the plain path), and single bit-equal to ``generate_core``.
* Two gloo ranks, at ``MULTICHIP_r05.json``'s configuration (zeroscope-tiny,
  16 x 32x32, 2 steps, "dry run", seed 0): fsdp on (1, 2, 1), hybrid,
  hybrid_ctx, cp_exact and cp_ulysses on (1, 1, 2). fsdp is bit-equal to the
  port's single (the gathered weights are the whole ones), cp_ulysses sits
  within that file's bound of single (3.72e-4; measured 0: with the
  GroupNorm moments summed in float64 the per-head all-to-all path is
  bit-equal to single here) and the chunked ones within its hybrid_ctx bound
  (1.94e-3; measured 0) of the same chunked program on one device. cp_exact
  does not meet that file's 1.40e-3 (JAX at (1, 1, 8)): the ring merges
  block statistics in another order than one softmax, and the bf16 latents
  turn that float32 rounding difference into flips; the port measures 3.20e-3 at 2
  ranks, JAX itself 2.30e-3 at (1, 1, 2) (both printed under -rP). It is
  held to 5e-3, the limit ``__graft_entry__.dryrun_multichip`` asserts for
  the JAX cp_exact (ROADMAP §3). Every preset within 2e-2 of JAX's result
  on the matching CPU mesh. zeroscope-tiny-hf (the diffusers temporal style:
  frame-axis attention, the temporal GroupNorms) under cp_exact and
  cp_ulysses at 2 ranks within 2e-2 of the port's single and of JAX's
  cp_exact (measured 2.2e-3: the single-device path runs frame attention
  as ``temporal_attention_plain``, the ring and Ulysses as per-head
  attention, so float32 rounding differs and a bf16 latent can flip).

The ranks run ``tests/torch_dist_workers.py`` through ``run_ranks``, which
rendezvous through a file in ``tmp_path`` and fail (not hang) past 60 s or
when a rank dies.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvdx_tpu.models.text_encoder import tokenize_batch
from dvdx_tpu.ops import rng as jrng
from dvdx_tpu.parallel import chunking as jchunk
from dvdx_tpu.parallel import latent_chunking as jlat
from dvdx_tpu.parallel import sharding as jshard
from dvdx_tpu.parallel import strategies as jstrat
from dvdx_tpu.parallel.mesh import make_mesh as jmake_mesh
from dvdx_tpu.pipelines.text2video import _save_flat_npz
from dvdx_tpu.scoring import temporal as jtemporal
from dvdx_tpu_torch.ops import rng
from dvdx_tpu_torch.ops.scheduler import make_ddim_schedule
from dvdx_tpu_torch.parallel import chunking, latent_chunking, sharding, strategies
from dvdx_tpu_torch.parallel.mesh import Mesh, run_ranks, single_device_mesh
from dvdx_tpu_torch.pipelines.text2video import build_pipeline, generate_core
from dvdx_tpu_torch.scoring import temporal
from dvdx_tpu_torch.utils.bridge import load_pipeline_params
from tests import torch_dist_workers as workers

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANS = [(16, 4, 2), (16, 1, 2), (25, 5, 3), (8, 8, 1), (16, 2, 2), (24, 3, 2), (9, 2, 1)]
MODEL = "zeroscope-tiny-hf"
JAX_TOL = 2e-2  # decoded frames in [-1, 1], port against JAX (measured <= 1.1e-2)


def _bounds():
    """MULTICHIP_r05.json's measured max-abs errors of the JAX strategies."""
    import re

    tail = json.load(open(os.path.join(REPO, "MULTICHIP_r05.json")))["tail"]
    out = {}
    for seg in tail.split("OK:", 1)[1].split("|"):
        m = re.match(r"\s*(fsdp|cp_exact|cp_ulysses|hybrid_ctx)\b.*?max_abs_err=([0-9.e-]+)", seg)
        if m:
            out.setdefault(m[1], float(m[2]))
    return out


BOUNDS = {"fsdp": 3.24e-3, "cp_exact": 1.40e-3, "cp_ulysses": 3.72e-4, "hybrid_ctx": 1.94e-3}
# the port's ring is held to the JAX dry run's own cp_exact limit (docstring)
RING_LIMIT = 5e-3


def test_bounds_are_multichip_r05s():
    assert _bounds() == BOUNDS


# --- chunking ---------------------------------------------------------------


@pytest.mark.parametrize("nf,nc,ov", PLANS)
def test_plan_chunks_equal_jax(nf, nc, ov):
    a, b = chunking.plan_chunks(nf, nc, ov), jchunk.plan_chunks(nf, nc, ov)
    np.testing.assert_array_equal(a.frame_index, b.frame_index)
    np.testing.assert_array_equal(a.weights, b.weights)
    assert a.frame_index.dtype == b.frame_index.dtype and a.weights.dtype == b.weights.dtype
    assert (a.num_chunks, a.chunk_len, a.num_frames) == (b.num_chunks, b.chunk_len,
                                                         b.num_frames)
    assert latent_chunking.chunk_bounds(a) == jlat.chunk_bounds(b)


def test_auto_chunk_count_equal_jax():
    for frames in (1, 4, 8, 9, 16, 24, 25, 64):
        for shards in (1, 2, 3, 4, 8):
            for target in (4, 8):
                assert chunking.auto_chunk_count(frames, shards, target) == \
                    jchunk.auto_chunk_count(frames, shards, target), (frames, shards, target)


@pytest.mark.parametrize("nf,nc,ov", PLANS)
def test_gather_and_blend_match_jax(nf, nc, ov):
    """gather exactly; the float32 blend within 1e-6 (its sums run in
    another order than JAX's segment_sum)."""
    plan = chunking.plan_chunks(nf, nc, ov)
    x = np.random.default_rng(nf * 10 + nc).normal(size=(2, nf, 3, 2, 4)).astype(np.float32)
    g = chunking.gather_chunks(torch.from_numpy(x), plan)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jchunk.gather_chunks(jnp.asarray(x),
                                                                             plan)))
    chunks = np.random.default_rng(1).normal(size=g.shape).astype(np.float32)
    ours = chunking.blend_chunks(torch.from_numpy(chunks), plan)
    ref = np.asarray(jchunk.blend_chunks(jnp.asarray(chunks), plan))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=0)
    # a constant video blends to itself (the weights normalise)
    const = chunking.blend_chunks(chunking.gather_chunks(torch.full((1, nf, 2, 2, 1), 3.5),
                                                         plan), plan)
    np.testing.assert_allclose(const.numpy(), 3.5, rtol=1e-6)


def test_split_and_stitch_match_jax():
    lat = np.random.default_rng(3).normal(size=(16, 4, 4, 4)).astype(np.float32)
    ours, plan = latent_chunking.split_latent(lat, 3, 2)
    ref, jplan = jlat.split_latent(lat, 3, 2)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    noisy = [c + np.float32(0.1) * i for i, c in enumerate(ours)]
    np.testing.assert_allclose(latent_chunking.stitch_chunks(noisy, plan),
                               jlat.stitch_chunks(noisy, jplan), atol=1e-6, rtol=0)


def test_temporal_metrics_equal_jax():
    video = np.random.default_rng(5).integers(0, 255, (8, 32, 32, 3), dtype=np.uint8)
    video[4:] = np.roll(video[3], 2, axis=1)  # a boundary with motion
    bounds = latent_chunking.chunk_bounds(chunking.plan_chunks(8, 3, 2))
    pairs = temporal.boundary_pairs(bounds)
    assert pairs == jtemporal.boundary_pairs(bounds)
    assert temporal.temporal_instability(video, pairs) == \
        jtemporal.temporal_instability(video, pairs)
    assert temporal.flow_warp_error(video, pairs) == jtemporal.flow_warp_error(video, pairs)
    assert temporal.global_temporal_instability(video) == \
        jtemporal.global_temporal_instability(video)


# --- sharding ---------------------------------------------------------------


@pytest.mark.parametrize("model_size", [1, 2, 3, 4, 8])
def test_leaf_spec_equals_jax(model_size):
    shapes = [(256, 128), (3,), (128, 127), (64, 64, 3, 3), (2 ** 14,), (2 ** 14 - 1,),
              (5, 4096), (320, 1280), (7, 9, 11, 13)]
    for shape in shapes:
        assert sharding._leaf_spec(shape, model_size) == \
            tuple(jshard._leaf_spec(shape, model_size)), (shape, model_size)


@pytest.fixture(scope="module")
def jax_tiny_hf(tiny_hf_pipeline):
    return tiny_hf_pipeline


@pytest.fixture(scope="module")
def bridged(jax_tiny_hf, tmp_path_factory):
    """(JAX pipeline, the port's with its weights, the weights' flat npz)."""
    tree = jax.tree.map(np.asarray, jax_tiny_hf.params)
    path = str(tmp_path_factory.mktemp("w") / "weights.npz")
    _save_flat_npz(path, tree)
    return jax_tiny_hf, load_pipeline_params(build_pipeline(MODEL, device="cpu"), tree), path


@pytest.mark.parametrize("model_size", [1, 2, 4])
def test_sharded_size_per_device_equals_jax(bridged, model_size):
    jp, port, _ = bridged
    jmesh = jmake_mesh((1, model_size, 1), devices=jax.devices()[:model_size])
    mesh = Mesh((1, model_size, 1), "cpu")
    mods = {"unet": port.unet, "text": port.text_encoder, "vae_dec": port.vae_decoder}
    jtree = {k: jp.params[k] for k in ("unet", "text", "vae_dec")}
    for shard in (True, False):
        assert sharding.sharded_size_per_device(mods, mesh, shard) == \
            jshard.sharded_size_per_device(jtree, jmesh, shard)


# --- strategies -------------------------------------------------------------


def test_presets_equal_jax():
    assert list(strategies.PRESETS) == list(jstrat.PRESETS)
    for name, st in strategies.PRESETS.items():
        assert dataclasses.asdict(st) == dataclasses.asdict(jstrat.PRESETS[name])
    assert strategies.get_strategy("chunk", num_chunks=3).num_chunks == 3
    with pytest.raises(KeyError):
        strategies.get_strategy("warp")


def _ids(pipe):
    return tokenize_batch(["", workers.PROMPT], pipe.spec.text.vocab_size,
                          pipe.spec.text.max_length)


def _jax_frames(jp, name, shape, frames=8, **overrides):
    n = int(np.prod(shape))
    runner = jstrat.build_runner(jp, jstrat.get_strategy(name, **overrides),
                                 jmake_mesh(shape, devices=jax.devices()[:n]),
                                 num_frames=frames, height=16, width=16, num_steps=2)
    return np.asarray(runner(jp.params, jnp.asarray(_ids(jp)), jrng.base_key(5)))


def test_single_runner_is_generate_core(bridged):
    _, port, _ = bridged
    ids = torch.from_numpy(_ids(port)).long()
    runner = strategies.build_runner(port, strategies.get_strategy("single"),
                                     single_device_mesh("cpu"), **workers.GEO)
    with torch.inference_mode():
        ref = generate_core(port, ids, rng.base_key(5), sched=make_ddim_schedule(2),
                            num_frames=8, height=16, width=16, guidance_scale=7.5)
    assert torch.equal(runner(ids, rng.base_key(5)), ref)


@pytest.mark.parametrize("name", ["chunk", "hybrid_ctx", "precond"])
def test_one_process_strategies_match_jax(bridged, name):
    jp, port, _ = bridged
    ref = _jax_frames(jp, name, (1, 1, 1), frames=16)
    runner = strategies.build_runner(port, strategies.get_strategy(name),
                                     single_device_mesh("cpu"), num_frames=16, height=16,
                                     width=16, num_steps=2)
    assert (runner.plan.num_chunks, runner.plan.chunk_len) == (2, 9)
    got = runner(torch.from_numpy(_ids(port)).long(), rng.base_key(5)).numpy()
    err = float(np.abs(got - ref).max())
    print(f"{name}: port against JAX max_abs_err {err:.3g}")  # pytest -rP
    assert got.shape == ref.shape == (16, 16, 16, 3) and err <= JAX_TOL


TWO_RANK = [("fsdp", (1, 2, 1), {}), ("hybrid", (1, 1, 2), {}), ("hybrid_ctx", (1, 1, 2), {}),
            ("cp_exact", (1, 1, 2), {}), ("cp_ulysses", (1, 1, 2), {})]
# MULTICHIP_r05.json's run (__graft_entry__.dryrun_multichip)
MULTICHIP = dict(geo=dict(num_frames=16, height=32, width=32, num_steps=2),
                 prompt="dry run", seed=0)


@pytest.fixture(scope="module")
def tiny_weights(tiny_pipeline, tmp_path_factory):
    """(JAX zeroscope-tiny, its weights' flat npz)."""
    path = str(tmp_path_factory.mktemp("w") / "tiny.npz")
    _save_flat_npz(path, jax.tree.map(np.asarray, tiny_pipeline.params))
    return tiny_pipeline, path


@pytest.fixture(scope="module")
def two_ranks(tiny_weights, tmp_path_factory):
    cases = [("single", (1, 1, 2), {})] + TWO_RANK
    return run_ranks(workers.presets, 2,
                     args=("zeroscope-tiny", tiny_weights[1], cases, MULTICHIP["geo"],
                           MULTICHIP["prompt"], MULTICHIP["seed"]),
                     device="cpu", timeout_s=60, workdir=str(tmp_path_factory.mktemp("ranks")))


@pytest.fixture(scope="module")
def two_ranks_hf(bridged, tmp_path_factory):
    cases = [("cp_exact", (1, 1, 2), {}), ("cp_ulysses", (1, 1, 2), {})]
    return run_ranks(workers.presets, 2, args=(MODEL, bridged[2], cases), device="cpu",
                     timeout_s=60,
                     workdir=str(tmp_path_factory.mktemp("ranks_hf")))


def test_fsdp_two_ranks_bit_equal_to_single(two_ranks):
    for rank, out in enumerate(two_ranks):
        assert torch.equal(out["fsdp"], out["single@1"]), rank
        assert torch.equal(out["single"], out["single@1"]), rank
        assert out["fsdp:gathers"] > 0  # the hooks all-gathered
    assert torch.equal(two_ranks[0]["fsdp"], two_ranks[1]["fsdp"])


@pytest.mark.parametrize("name", ["hybrid", "hybrid_ctx", "cp_exact", "cp_ulysses"])
def test_two_ranks_within_multichip_bounds(two_ranks, name):
    """cp_*: against the port's single; chunked: against the same chunked
    program on one device (MULTICHIP_r05's hybrid_ctx comparison)."""
    bound = BOUNDS["hybrid_ctx" if name.startswith("hybrid") else name]
    if name == "cp_exact":
        bound = RING_LIMIT
    for rank, out in enumerate(two_ranks):
        ref = out["single@1"] if name.startswith("cp") else out[name + "@1"]
        err = float((out[name] - ref).abs().max())
        print(f"{name} rank {rank}: max_abs_err {err:.3g} (bound {bound})")  # pytest -rP
        assert err <= bound, (name, rank, err)
    assert torch.equal(two_ranks[0][name], two_ranks[1][name])


@pytest.mark.parametrize("name,shape", [(n, s) for n, s, _ in TWO_RANK])
def test_two_ranks_match_jax_mesh(tiny_weights, two_ranks, name, shape):
    jp = tiny_weights[0]
    st = jstrat.get_strategy(name)
    if st.chunked:
        st = jstrat.get_strategy(name, num_chunks=jchunk.auto_chunk_count(16, shape[2]))
    ids = jnp.asarray(tokenize_batch(["", MULTICHIP["prompt"]], jp.spec.text.vocab_size,
                                     jp.spec.text.max_length))
    runner = jstrat.build_runner(jp, st, jmake_mesh(shape, devices=jax.devices()[:2]),
                                 **MULTICHIP["geo"])
    ref = np.asarray(runner(jp.params, ids, jrng.base_key(MULTICHIP["seed"])))
    err = float(np.abs(two_ranks[0][name].numpy() - ref).max())
    print(f"{name} {shape}: port (2 gloo ranks) against JAX (CPU mesh) {err:.3g}")
    assert err <= JAX_TOL
    if name == "cp_exact":  # JAX's own cp_exact at this mesh, for ROADMAP §3.3
        single = jstrat.build_runner(jp, jstrat.get_strategy("single"),
                                     jmake_mesh((1, 1, 1), devices=jax.devices()[:1]),
                                     **MULTICHIP["geo"])
        own = np.abs(ref - np.asarray(single(jp.params, ids,
                                             jrng.base_key(MULTICHIP["seed"])))).max()
        print(f"JAX cp_exact {shape} against JAX single: {own:.3g}")  # pytest -rP


# ROADMAP §3.3: one float32 UNet call of the exact-CP program, port at 2 gloo
# ranks against JAX on a (1, 1, 2) CPU mesh, before any bf16 latent rounding:
# float32 summation order alone (measured 1.06e-6 of max|eps|)
CP_EPS_TOL = 1e-5


def test_cp_exact_unet_call_equals_jax_ring_in_float32(tiny_weights, tmp_path):
    """The port's ring (``ops/ring_attention.py``), frame-sharded GroupNorm
    and conv halos compute the JAX cp_exact function: eps of one CFG UNet
    call of float32 zeroscope-tiny on 16 frames, its frames split over 2
    ranks, within CP_EPS_TOL of max|eps| of the JAX cp_exact call (ring
    attention under ``ring_context`` and ``frames_major``, GSPMD elsewhere)
    on the same weights and inputs, and of both one-device calls."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dvdx_tpu.ops.attention import ring_context as jring_context
    from dvdx_tpu.ops.layout import frames_major

    jp, weights = tiny_weights
    rng = np.random.default_rng(33)
    z = rng.normal(size=(2, 16, 4, 4, 4)).astype(np.float32)
    hidden = rng.normal(size=(2, jp.spec.text.max_length, jp.spec.text.hidden_size)).astype(
        np.float32)
    t = np.full((2,), int(make_ddim_schedule(2).timesteps[0]), np.int32)
    jmesh = jmake_mesh((1, 1, 2), devices=jax.devices()[:2])

    def cp(params, z, t, h):
        z = jax.lax.with_sharding_constraint(z, NamedSharding(jmesh, P(None, "seq")))
        return jp.unet.apply(params, z, t, h)

    with jring_context(jmesh, "seq", algo="ring"), frames_major():
        jax_cp = np.asarray(jax.jit(cp)(jp.params["unet"], z, t, hidden))
    jax_single = np.asarray(jax.jit(jp.unet.apply)(jp.params["unet"], z, t, hidden))
    outs = run_ranks(workers.cp_unet_call, 2,
                     args=("zeroscope-tiny", weights, torch.from_numpy(z), torch.from_numpy(t),
                           torch.from_numpy(hidden)),
                     device="cpu", timeout_s=60, workdir=str(tmp_path / "ranks"))
    scale = float(np.abs(jax_single).max())
    for rank, (port_cp, port_single) in enumerate(outs):
        errs = {"port cp_exact vs JAX cp_exact": np.abs(port_cp.numpy() - jax_cp).max(),
                "port cp_exact vs port single": (port_cp - port_single).abs().max().item(),
                "port single vs JAX single": np.abs(port_single.numpy() - jax_single).max()}
        print(f"rank {rank}: " + ", ".join(f"{k} {v / scale:.3g}" for k, v in errs.items())
              + f" (of max|eps| {scale:.3g}; JAX cp_exact vs JAX single "
              f"{np.abs(jax_cp - jax_single).max() / scale:.3g})")  # pytest -rP
        assert all(v <= CP_EPS_TOL * scale for v in errs.values()), errs


@pytest.mark.parametrize("name", ["cp_exact", "cp_ulysses"])
def test_hf_context_parallel_two_ranks(bridged, two_ranks_hf, name):
    """The diffusers temporal style under exact CP: frame-axis attention
    through the ring / Ulysses, the temporal GroupNorms' moments and the
    conv halos across the ranks."""
    jp, port, _ = bridged
    single = strategies.build_runner(port, strategies.get_strategy("single"),
                                     single_device_mesh("cpu"), **workers.GEO)
    ids = torch.from_numpy(_ids(port)).long()
    ref_port = single(ids, rng.base_key(5))
    ref_jax = _jax_frames(jp, "cp_exact", (1, 1, 2))
    for rank, out in enumerate(two_ranks_hf):
        e_port = float((out[name] - ref_port).abs().max())
        e_jax = float(np.abs(out[name].numpy() - ref_jax).max())
        print(f"hf {name} rank {rank}: against the port's single {e_port:.3g}, "
              f"JAX cp_exact {e_jax:.3g}")  # pytest -rP
        assert e_port <= JAX_TOL and e_jax <= JAX_TOL


def test_runner_refuses_unsplittable_cp(bridged):
    _, port, _ = bridged
    with pytest.raises(ValueError, match="split"):
        strategies.build_runner(port, strategies.get_strategy("cp_exact"),
                                Mesh((1, 1, 3), "cpu"), **workers.GEO)
