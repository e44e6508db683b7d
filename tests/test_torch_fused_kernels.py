"""Port vs reference: the slice-2 kernels' plain versions against the JAX
package's Pallas functions (interpret mode on the CPU), the fused branches
of the port's modules against the JAX modules forced onto their Pallas
branches, the whole UNet with both fused kernels, and the port's routing at
the zeroscope-v2-576w standard geometry.

Inputs are numpy draws from fixed seeds. Tolerances:
* float32: 1e-5 absolute for the kernels (the two sides sum in other orders,
  and the JAX kernels' erf is the A&S 7.1.26 polynomial, |error| <= 1.5e-7,
  where the port uses torch.erf); the modules and the UNet as stated there;
* bfloat16: both sides round at the same points, but a one-ulp difference
  in an intermediate (a sum taken in another order) can flip later
  roundings; BF16_ULPS bf16 ulps (2^-8 relative) of max|ref|.
The parameters handed to the JAX side in bfloat16 runs are bf16-representable
float32 values, so that both sides see the same weights and vectors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvdx_tpu.models import layers as jlayers
from dvdx_tpu.models.unet3d import UNet3D as JUNet3D
from dvdx_tpu.models.unet3d import UNet3DConfig as JUNet3DConfig
from dvdx_tpu.ops import attention as jattention
from dvdx_tpu.ops.pallas import flash_attention as jflash
from dvdx_tpu.ops.pallas.spatial_tail import fused_spatial_tail as j_tail
from dvdx_tpu.ops.pallas.temporal_block import fused_temporal_block as j_block
from dvdx_tpu_torch.models import layers, unet3d
from dvdx_tpu_torch.ops import attention
from dvdx_tpu_torch.ops.kernels import flash_attention as tflash
from dvdx_tpu_torch.ops.kernels import spatial_tail as ttail
from dvdx_tpu_torch.ops.kernels import temporal_block as tblock
from dvdx_tpu_torch.utils.bridge import load_jax_params
from dvdx_tpu_torch.utils.testing import reference_check_spec

torch.set_num_threads(2)

BF16_ULPS = 4
TOL_F32 = 1e-5


def _report(got, want) -> float:
    """Print the measured error beside the scale (pytest -rP); return it."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    print(f"parity: max_abs_err {err:.3g}, max_abs_ref {np.abs(want).max():.3g}")
    return err


def _check(got, want, dtype):
    err = _report(got, want)
    if dtype == "float32":
        assert err <= TOL_F32, err
    else:
        scale = float(np.abs(np.asarray(want, np.float32)).max())
        assert err <= BF16_ULPS * 2.0 ** -8 * scale, (err, scale)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _draw_params(shapes: dict, seed: int) -> dict:
    """JAX-layout float32 parameters, bf16-representable: matrices N(0,
    1/fan_in), LayerNorm scales 1 + N(0, 0.1^2), other vectors N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in shapes.items():
        if len(shape) == 2:
            a = rng.normal(size=shape) * shape[0] ** -0.5
        else:
            a = rng.normal(size=shape) * 0.1 + (1.0 if key.endswith("_s") else 0.0)
        out[key] = torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()
    return out


def _port_params(jparams: dict, dtype: torch.dtype) -> dict:
    """JAX layout (in, out) -> the port's nn.Linear layout (out, in)."""
    return {k: torch.from_numpy(v.T.copy() if v.ndim == 2 else v).to(dtype)
            for k, v in jparams.items()}


def _inputs(shapes, seed, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jdt = getattr(jnp, dtype)
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


# --- kernels ------------------------------------------------------------------

def _tail_shapes(c, hd, inner):
    return {"o1_w": (hd, c), "o1_b": (c,), "ln2_s": (c,), "ln2_b": (c,),
            "q2_w": (c, hd), "o2_w": (hd, c), "o2_b": (c,), "ln3_s": (c,),
            "ln3_b": (c,), "ffi_w": (c, 2 * inner), "ffi_b": (2 * inner,),
            "ffo_w": (inner, c), "ffo_b": (c,)}


@pytest.mark.parametrize("impl", ["resident", "streamed"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spatial_tail_plain_matches_pallas(impl, dtype, monkeypatch):
    """Both Pallas bodies (the resident one and, forced by
    DVDX_SPATIAL_TAIL_IMPL, the streamed one) at N=2, S=32, C=64, 2 heads,
    a 7-token context."""
    n, s, c, heads, t = 2, 32, 64, 2, 7
    monkeypatch.setenv("DVDX_SPATIAL_TAIL_IMPL", impl)
    jp = _draw_params(_tail_shapes(c, c, 4 * c), 1)
    (jx, jo1, jk, jv), (tx, to1, tk, tv) = _inputs(
        [(n, s, c), (n, s, c), (n, t, c), (n, t, c)], 2, dtype)
    want = j_tail(jx, jo1, jk, jv, {k: jnp.asarray(v) for k, v in jp.items()},
                  heads=heads, interpret=True)
    got = ttail.fused_spatial_tail(tx, to1, tk, tv, _port_params(jp, getattr(torch, dtype)),
                                   heads=heads)
    assert got.dtype == getattr(torch, dtype) and got.shape == (n, s, c)
    _check(_f32(got), _f32(want), dtype)


def _block_shapes(c, inner):
    shapes = {}
    for i in (1, 2):
        shapes.update({f"ln{i}_s": (c,), f"ln{i}_b": (c,), f"q{i}": (c, c),
                       f"k{i}": (c, c), f"v{i}": (c, c), f"o{i}_w": (c, c),
                       f"o{i}_b": (c,)})
    shapes.update({"ln3_s": (c,), "ln3_b": (c,), "ffi_w": (c, 2 * inner),
                   "ffi_b": (2 * inner,), "ffo_w": (inner, c), "ffo_b": (c,)})
    return shapes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("f,n,heads,d", [(4, 20, 2, 40), (16, 12, 1, 64)])
def test_temporal_block_plain_matches_pallas(dtype, f, n, heads, d):
    """F = 4 and 16, head dims 40 and 64; N is not a multiple of the Pallas
    kernel's 8-position tile, so its ragged tail is masked there."""
    c = heads * d
    jp = _draw_params(_block_shapes(c, 4 * c), 3)
    (jx,), (tx,) = _inputs([(1, f, n, c)], 4, dtype)
    want = j_block(jx, {k: jnp.asarray(v) for k, v in jp.items()}, heads=heads,
                   interpret=True)
    got = tblock.fused_temporal_block(tx, _port_params(jp, getattr(torch, dtype)),
                                      heads=heads)
    _check(_f32(got), _f32(want), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sk", [128, 77])
def test_flash_mh_plain_matches_pallas(dtype, sk):
    """Self-attention (Sk = Sq = 128) and a 77-key context, 2 heads of 64
    in 128-lane strips; the output's pad lanes are exactly zero."""
    b, sq, heads, d = 1, 128, 2, 64
    rng = np.random.default_rng(5)

    def strips(s):
        x = np.zeros((b, s, heads, 128), np.float32)
        x[..., :d] = rng.normal(size=(b, s, heads, d))
        return x.reshape(b, s, heads * 128)
    arrs = [strips(sq), strips(sk), strips(sk)]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jflash.flash_attention_mh(*(jnp.asarray(a, jdt) for a in arrs), heads=heads,
                                     head_dim=d, interpret=True)
    got = tflash.flash_attention_mh(*(torch.from_numpy(a).to(tdt) for a in arrs),
                                    heads=heads, head_dim=d)
    assert float(got.view(b, sq, heads, 128)[..., d:].abs().max()) == 0.0
    _check(_f32(got), _f32(want), dtype)


@pytest.mark.parametrize("s_q,s_kv,heads,head_dim", [
    (2880, 2880, 5, 64), (2880, 77, 5, 64), (720, 720, 10, 64), (256, 256, 2, 64),
    (1024, 600, 2, 64), (1024, 1024, 1, 160), (9216, 77, 5, 64)])
def test_wants_native_mh_matches_shape_gate(s_q, s_kv, heads, head_dim, monkeypatch):
    """The port's gate is the JAX gate's shape conditions (the JAX package's
    opt-in switch forced on, at shapes its TPU block chooser takes)."""
    monkeypatch.setenv("DVDX_ATTN_MH_IMPL", "pallas")
    assert attention.wants_native_mh(s_q, s_kv, heads, head_dim) == \
        jattention.wants_native_mh(s_q, s_kv, heads, head_dim)


@pytest.mark.parametrize("heads,head_dim", [(2, 40), (3, 64), (1, 128)])
def test_pad_head_helpers_match(heads, head_dim):
    w = np.random.default_rng(6).normal(size=(24, heads * head_dim)).astype(np.float32)
    np.testing.assert_array_equal(
        tflash.pad_head_columns(torch.from_numpy(w), heads, head_dim).numpy(),
        np.asarray(jflash.pad_head_columns(jnp.asarray(w), heads, head_dim)))
    np.testing.assert_array_equal(
        tflash.pad_head_rows(torch.from_numpy(w.T.copy()), heads, head_dim).numpy(),
        np.asarray(jflash.pad_head_rows(jnp.asarray(w.T), heads, head_dim)))


# --- the fused branches of the modules ------------------------------------------

def _tree_paths(tree):
    return sorted(jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0])


def _bf16_representable(params, seed):
    """Every leaf plus N(0, 0.05^2) noise (so zero biases and unit scales
    carry signal), rounded to bf16-representable float32 values."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: torch.from_numpy(
        (np.asarray(a) + rng.normal(size=a.shape) * 0.05).astype(np.float32))
        .bfloat16().float().numpy(), params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_spatial_block_matches_jax_module(dtype, monkeypatch):
    """The port's BasicTransformerBlock takes its fused tail at S = 512 and
    equals the JAX block forced onto its Pallas tail
    (DVDX_SPATIAL_BLOCK_IMPL=pallas); both branches share one parameter
    tree, which the weight bridge loads unchanged."""
    b, s, heads, d, t, cx = 1, 512, 1, 64, 7, 48
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    (jx, jctx), (tx, tctx) = _inputs([(b, s, heads * d), (b, t, cx)], 7, dtype)
    jmod = jlayers.BasicTransformerBlock(heads * d, heads, d, cross_attention_dim=cx,
                                         dtype=jdt)
    monkeypatch.setenv("DVDX_SPATIAL_BLOCK_IMPL", "xla")
    unfused_tree = jax.jit(jmod.init)(jax.random.PRNGKey(0), jx, jctx)
    monkeypatch.setenv("DVDX_SPATIAL_BLOCK_IMPL", "pallas")
    params = _bf16_representable(jax.jit(jmod.init)(jax.random.PRNGKey(0), jx, jctx), 8)
    assert _tree_paths(params) == _tree_paths(unfused_tree)
    want = jax.jit(jmod.apply)(params, jx, jctx)
    port = layers.BasicTransformerBlock(heads * d, heads, d, cx).to(tdt)
    load_jax_params(port, params)
    assert port.fused(tx, tctx)
    with torch.no_grad():
        got = port(tx, tctx)
    _check(_f32(got), _f32(want), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,d", [(8, 8), (1, 64)])
def test_fused_temporal_block_matches_jax_module(dtype, heads, d, monkeypatch):
    """The port's _TemporalBlock takes the fused block at N = 64 positions
    and equals the JAX block forced onto its Pallas kernel
    (DVDX_TEMPORAL_BLOCK_IMPL=pallas); one parameter tree for both
    branches."""
    c = heads * d
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    (jx,), (tx,) = _inputs([(1, 4, 64, c)], 9, dtype)
    jmod = jlayers._TemporalBlock(c, heads, d, dtype=jdt)
    monkeypatch.setenv("DVDX_TEMPORAL_BLOCK_IMPL", "xla")
    unfused_tree = jax.jit(jmod.init)(jax.random.PRNGKey(1), jx)
    monkeypatch.setenv("DVDX_TEMPORAL_BLOCK_IMPL", "pallas")
    params = _bf16_representable(jax.jit(jmod.init)(jax.random.PRNGKey(1), jx), 10)
    assert _tree_paths(params) == _tree_paths(unfused_tree)
    want = jax.jit(jmod.apply)(params, jx)
    port = layers._TemporalBlock(c, heads, d).to(tdt)
    load_jax_params(port, params)
    assert port.fused(tx)
    with torch.no_grad():
        got = port(tx)
    _check(_f32(got), _f32(want), dtype)


@pytest.mark.parametrize("frames,heads,d", [(40, 4, 8), (72, 2, 32)])
def test_ungated_temporal_block_matches_jax_module(frames, heads, d, monkeypatch):
    """Blocks the fused kernel does not take -- 40 frames at C = 32 (not a
    multiple of 64), 72 frames at C = 64 (past the kernel's 64) -- run the
    port's unfused branch at N = 64 positions and equal the JAX
    _TemporalBlock's unfused (XLA) branch in float32, within TOL_F32 (the
    two sides sum in other orders)."""
    c = heads * d
    (jx,), (tx,) = _inputs([(1, frames, 64, c)], 13, "float32")
    monkeypatch.setenv("DVDX_TEMPORAL_BLOCK_IMPL", "xla")
    jmod = jlayers._TemporalBlock(c, heads, d, dtype=jnp.float32)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(3), jx)
    params = jax.tree.map(lambda a: a + 0.05 * np.random.default_rng(14).normal(
        size=a.shape).astype(np.float32), params)  # no zero leaves
    want = jax.jit(jmod.apply)(params, jx)
    port = layers._TemporalBlock(c, heads, d)
    load_jax_params(port, jax.tree.map(np.asarray, params))
    assert not port.fused(tx)
    with torch.no_grad():
        got = port(tx)
    _check(_f32(got), _f32(want), "float32")


@pytest.mark.parametrize("frames", [40, 130])
def test_frame_axis_temporal_block_matches_jax_module(frames, monkeypatch):
    """A _TemporalBlock at C = 64 over N = 8 positions (fewer than the fused
    block takes) runs unfused, its frame-axis attention through the gate
    ``temporal_attention_wants``: the kernel's wrapper at 40 frames, the
    plain tensor math past the kernel's 128; both equal the JAX block's
    unfused branch in float32 within TOL_F32."""
    heads, d = 2, 32
    c = heads * d
    (jx,), (tx,) = _inputs([(1, frames, 8, c)], 15, "float32")
    monkeypatch.setenv("DVDX_TEMPORAL_BLOCK_IMPL", "xla")
    jmod = jlayers._TemporalBlock(c, heads, d, dtype=jnp.float32)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(4), jx)
    params = jax.tree.map(lambda a: a + 0.05 * np.random.default_rng(16).normal(
        size=a.shape).astype(np.float32), params)  # no zero leaves
    want = jax.jit(jmod.apply)(params, jx)
    port = layers._TemporalBlock(c, heads, d)
    load_jax_params(port, jax.tree.map(np.asarray, params))
    assert not port.fused(tx)
    assert layers.temporal_attention_wants(frames, d) == (frames <= 128)
    with torch.no_grad():
        got = port(tx)
    _check(_f32(got), _f32(want), "float32")


# --- the UNet -------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_unets():
    """The JAX UNet of the port's reference-check structure (widths 64 /
    128 / 128 / 128, cross-attention at level 0), float32 flax init with
    zero leaves perturbed."""
    from dvdx_tpu.utils.testing import perturb_zero_params

    cfg = reference_check_spec("float32").unet
    jcfg = JUNet3DConfig(block_out_channels=cfg.block_out_channels,
                         layers_per_block=cfg.layers_per_block,
                         cross_attention_levels=cfg.cross_attention_levels,
                         cross_attention_dim=cfg.cross_attention_dim, dtype="float32")
    rng = np.random.default_rng(11)
    inputs = (rng.normal(size=(1, 2, 32, 16, 4)).astype(np.float32),
              np.array([801], np.int32),
              rng.normal(size=(1, 7, 64)).astype(np.float32))
    params = jax.jit(JUNet3D(jcfg).init)(jax.random.PRNGKey(2), *inputs)
    return jcfg, perturb_zero_params(params, seed=12, scale=0.1), inputs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unet_with_fused_kernels_matches_jax(reference_unets, dtype, monkeypatch):
    """Both fused kernels forced on the JAX side. Forced, the JAX package also
    fuses the mid block (S = N = 8 at these 32x16 latents), where the port's
    gates refuse; there the two sides differ only in rounding order, so the
    float32 run holds the slice to the UNet bound of test_torch_models
    (1e-3) and the bfloat16 run to 5% of the output's scale (one-ulp
    differences carried through ~20 layers)."""
    jcfg, params, (lat, ts, ctx) = reference_unets
    monkeypatch.setenv("DVDX_SPATIAL_BLOCK_IMPL", "pallas")
    monkeypatch.setenv("DVDX_TEMPORAL_BLOCK_IMPL", "pallas")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jparams = params if dtype == "float32" else jax.tree.map(
        lambda a: jnp.asarray(a, jnp.bfloat16), params)
    want = np.asarray(jax.jit(JUNet3D(dataclasses.replace(jcfg, dtype=dtype)).apply)(
        jparams, jnp.asarray(lat, jdt), ts, jnp.asarray(ctx, jdt)).astype(jnp.float32))
    port = unet3d.UNet3D(reference_check_spec(dtype).unet).to(tdt)
    load_jax_params(port, jax.tree.map(np.asarray, jparams))
    with torch.no_grad():
        got = port(torch.from_numpy(lat).to(tdt), torch.from_numpy(ts),
                   torch.from_numpy(ctx).to(tdt)).float().numpy()
    err = _report(got, want)
    assert np.abs(want).max() > 0.1
    bound = 1e-3 if dtype == "float32" else 0.05 * np.abs(want).max()
    assert err <= bound, (err, bound)


def test_gates_route_the_standard_geometry():
    """zeroscope-v2-576w at 16 x 576x320 (latents 40x72, CFG batch 2, 77
    text tokens): the fused tail takes exactly the five level-0 spatial
    transformers, the fused block transformer_in and the five level-0
    temporal transformers; everything else stays unfused."""
    with torch.device("meta"):
        unet = unet3d.UNet3D(unet3d.UNet3DConfig())
    tails, blocks, spatial, temporal = [], [], 0, 0
    for name, mod in unet.named_modules():
        if not isinstance(mod, (layers.SpatialTransformer, layers.TransformerTemporal)):
            continue
        top = name.split(".")[0]
        level = 0 if top == "transformer_in" else (3 if top.startswith("mid") else int(top.split("_")[1]))
        positions = (40 >> level) * (72 >> level)
        c = mod.proj_in.in_features
        if isinstance(mod, layers.SpatialTransformer):
            spatial += 1
            x = torch.empty(32, positions, c, device="meta")
            if mod.block0.fused(x, torch.empty(32, 77, 1024, device="meta")):
                tails.append(name)
        else:
            temporal += 1
            if mod.block0.fused(torch.empty(2, 16, positions, c, device="meta")):
                blocks.append(name)
    level0 = ["down_0_0", "down_0_1", "up_0_0", "up_0_1", "up_0_2"]
    assert (spatial, temporal) == (16, 17)
    assert tails == [f"{b}.spatial_attn" for b in level0]
    assert blocks == ["transformer_in"] + [f"{b}.temporal_attn" for b in level0]
