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
from dvdx_tpu_torch.ops.groupnorm import SHARDED_ROADMAP, group_norm_act_sharded
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


def test_sharded_groupnorm_refuses_the_card():
    """Over more than one rank a non-CPU tensor raises (the kernel takes no
    moments yet); its plain version never stands in for it."""
    x = torch.empty((1, 4, 8, 32), device="meta")
    w = torch.empty(32, device="meta")
    with pytest.raises(NotImplementedError, match="moments-in entry"):
        group_norm_act_sharded(x, w, w, groups=8, eps=1e-5, group=object(), group_size=2)
    assert "M10" in SHARDED_ROADMAP


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
