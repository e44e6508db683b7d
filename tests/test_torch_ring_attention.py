"""Ring and Ulysses attention, and the frame-sharded pieces of exact context
parallelism, against the JAX package (``dvdx_tpu/ops/ring_attention.py`` on
the 8-device CPU mesh, ``tests/test_ring_attention.py`` its own twin) and
against global attention, at 2 and 4 gloo ranks.

Tolerances (float32): ring within 3e-5 of global attention and of JAX's
ring (blockwise online softmax: accumulation order); Ulysses within 1e-6
(each head's softmax runs in one piece; measured 0.0 against the port's
global attention at these shapes, per-head attention over a head subset
rounds as over all heads here). The frame-sharded GroupNorm equals the
one-device plain version (its float64 moment sums round to the same float32
moments); the (3, 1) conv over a one-frame halo equals the padded one-device
conv within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvdx_tpu.ops.attention import _xla_attention
from dvdx_tpu.ops.ring_attention import ring_attention as jring
from dvdx_tpu.ops.ring_attention import ulysses_attention as julysses
from dvdx_tpu.parallel.mesh import make_mesh as jmake_mesh
from dvdx_tpu_torch.models import layers
from dvdx_tpu_torch.ops.attention import multi_head_attention, ring_active, ring_context
from dvdx_tpu_torch.parallel.mesh import Mesh, run_ranks
from tests import torch_dist_workers as workers

RING_SHAPES = [(2, 64, 2, 16), (1, 128, 4, 32)]
ULYSSES_SHAPES = [(2, 64, 8, 16), (1, 128, 16, 32)]


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(3))


CASES = ([("ring", s, 0) for s in RING_SHAPES] + [("ulysses", s, 1) for s in ULYSSES_SHAPES]
         + [("ulysses", (1, 64, 5, 16), 2)])  # zeroscope's level-0 head count


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    cases = [(algo,) + tuple(torch.from_numpy(a) for a in _qkv(shape, seed))
             for algo, shape, seed in CASES]
    outs = run_ranks(workers.attention, request.param, args=(cases,), device="cpu",
                     timeout_s=60,
                     workdir=str(tmp_path_factory.mktemp(f"attn{request.param}")))
    return request.param, outs


def _jax(fn, world, q, k, v):
    mesh = jmake_mesh((1, 1, world), devices=jax.devices()[:world])
    return np.asarray(jax.jit(lambda a, b, c: fn(a, b, c, mesh))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


def _stitched(outs, i):
    return torch.cat([o[0][i][0] for o in outs], dim=1).numpy()


@pytest.mark.parametrize("i", range(len(RING_SHAPES)))
def test_ring_matches_global_and_jax(ranks, i):
    world, outs = ranks
    _, shape, seed = CASES[i]
    q, k, v = _qkv(shape, seed)
    got = _stitched(outs, i)
    glob = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     shape[-1] ** -0.5))
    np.testing.assert_allclose(got, glob, atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(got, _jax(jring, world, q, k, v), atol=3e-5, rtol=3e-5)
    for got_blk, ref_blk in outs[0][0][i:i + 1]:
        np.testing.assert_allclose(got_blk.numpy(), ref_blk.numpy(), atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("i", range(len(RING_SHAPES), len(RING_SHAPES) + len(ULYSSES_SHAPES)))
def test_ulysses_matches_global_and_jax(ranks, i):
    world, outs = ranks
    _, shape, seed = CASES[i]
    q, k, v = _qkv(shape, seed)
    got = _stitched(outs, i)
    ours_global = np.concatenate([o[0][i][1].numpy() for o in outs], axis=1)
    err = float(np.abs(got - ours_global).max())
    print(f"ulysses {shape} at {world} ranks against the port's global attention: "
          f"{err:.3g}")  # pytest -rP
    assert err <= 1e-6
    np.testing.assert_allclose(got, _jax(julysses, world, q, k, v), atol=1e-6, rtol=1e-6)


def test_ulysses_rejects_indivisible_heads(ranks):
    world, outs = ranks
    for o in outs:
        msg = o[0][-1][0]
        assert isinstance(msg, str) and "divisible" in msg
    q = jnp.ones((1, 64, 5, 16))
    with pytest.raises(ValueError, match="divisible"):
        jax.jit(lambda a: julysses(a, a, a, jmake_mesh((1, 1, world),
                                                       devices=jax.devices()[:world])))(q)


def test_auto_dispatch_per_head_count(ranks):
    """Inside ring_context(algo='auto') heads that divide the group take
    Ulysses, the others the ring (the JAX dispatch)."""
    world, outs = ranks
    for o in outs:
        taken = o[1]
        assert taken == {2 * world: ["ulysses"], 2 * world + 1: ["ring"]}, taken


def test_frame_sharded_groupnorm_and_halo(tmp_path):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(2, 8, 6, 16)).astype(np.float32)) * 3 + 1
    gamma = torch.from_numpy(rng.normal(size=16).astype(np.float32))
    beta = torch.from_numpy(rng.normal(size=16).astype(np.float32))
    weight = torch.from_numpy(rng.normal(size=(16, 16, 3, 1)).astype(np.float32)) * 0.2
    bias = torch.from_numpy(rng.normal(size=16).astype(np.float32))
    for world in (2, 4):
        outs = run_ranks(workers.frame_pieces, world, args=(x, gamma, beta, weight, bias),
                         device="cpu", timeout_s=60, workdir=str(tmp_path / f"w{world}"))
        for gn, gn_ref, halo, conv_ref in outs:
            assert torch.equal(gn, gn_ref)
            np.testing.assert_allclose(halo.numpy(), conv_ref.numpy(), atol=1e-6, rtol=0)


def test_ring_context_routes_the_layers():
    """Inside a ring context the fused spatial tail and temporal block are
    off (the JAX gates); outside it the routing is unchanged."""
    args_tail = (2880, 320, 5, 64, 77)
    args_block = (16, 2880, 320, 5, 64)
    assert layers.fused_spatial_tail_wants(*args_tail)
    assert layers.fused_temporal_block_wants(*args_block)
    mesh = Mesh((1, 1, 2), "cpu")
    with ring_context(mesh, "seq", algo="auto"):
        assert ring_active()
        assert not layers.fused_spatial_tail_wants(*args_tail)
        assert not layers.fused_temporal_block_wants(*args_block)
    assert not ring_active()
    with pytest.raises(ValueError, match="cp algo"):
        with ring_context(mesh, "seq", algo="tree"):
            pass


def test_ring_impl_outside_a_context_is_the_default():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 16, 2, 8), 3))
    assert torch.equal(multi_head_attention(q, k, v, impl="ring"),
                       multi_head_attention(q, k, v))
    with ring_context(Mesh((1, 1, 1), "cpu")):  # a one-rank seq axis
        assert torch.equal(multi_head_attention(q, k, v, impl="ring"),
                           multi_head_attention(q, k, v))


# ROADMAP §3.5: the fused plain versions against the unfused modules in
# float32, their operation order amplified by CFG 7.5 over 3 DDIM steps
# (measured 5.0e-6 relative RMS after one step, 7.2e-6 after three)
ROUTED_F32_TOL = 2e-5


def test_routed_program_at_one_rank_is_single_in_float32(monkeypatch):
    """The exact-CP program at a seq axis of one (the routed layers: fused
    tail and block off, attention with impl='ring', the conv halo, the
    frame-sharded GroupNorm's entry) against the one-device program, both
    float32 latents through the float32 reference-check model (widths 64 /
    128, whose level 0 the fused gates take outside the context), 3 DDIM
    steps: bit-equal to the same program with the fused gates off and no
    route taken, and within ROUTED_F32_TOL relative RMS of single. So at one
    rank the routes add nothing; what the card measures in bf16 is the
    unfused path's rounding."""
    from dvdx_tpu_torch.ops.scheduler import make_ddim_schedule
    from dvdx_tpu_torch.parallel.mesh import single_device_mesh
    from dvdx_tpu_torch.pipelines.text2video import denoise
    from dvdx_tpu_torch.utils.testing import (reference_check_inputs,
                                              reference_check_pipeline, relative_rms)

    pipe = reference_check_pipeline("float32", "cpu")
    z, hidden, _ = reference_check_inputs(pipe)
    z = z.float()
    sched = make_ddim_schedule(25)
    calls = dict.fromkeys(("frame_halo", "group_norm_act_sharded"), 0)
    for name in calls:
        def counted(*a, _name=name, _fn=getattr(layers, name), **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(layers, name, counted)

    def run(**kw):
        return denoise(pipe.unet, sched, z, hidden[1:2], hidden[0:1], 7.5, step_range=(0, 3),
                       **kw)

    with torch.inference_mode():
        single = run()
        with monkeypatch.context() as m:  # the fused gates off, no ring context
            m.setattr(layers, "ring_active", lambda: True)
            fused_off = run()
        assert calls == {"frame_halo": 0, "group_norm_act_sharded": 0}
        with ring_context(single_device_mesh("cpu"), "seq", algo="ring"):
            routed = run(frame_positions=torch.arange(z.shape[1]))
    assert single.dtype == routed.dtype == torch.float32
    assert all(calls.values()), calls
    assert torch.equal(routed, fused_off)
    dist_ = relative_rms(routed, single)
    print(f"routed at one rank vs single, float32, 3 steps: relative RMS {dist_:.3g}")
    assert dist_ <= ROUTED_F32_TOL
