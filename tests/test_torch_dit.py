"""Port vs reference: the video DiT family (dit-tiny, float32, the reference's
perturbed weights bridged into the port), v-prediction DDIM, DPM-Solver++(2M)
and the auxiliary noise stream, then the family through ``generate``,
``StepEngine`` and the network roles.

Tolerances: the DiT call agrees with the reference to 1e-6 absolute (measured
1.8e-7 at max |out| 0.63); the rotary tables to 5e-7 (measured 2.4e-7: two
float32 ulps of cos and sin at angles up to 60 rad). The
v-prediction DDIM step fuses the multiply-adds XLA fuses and is bit-equal at
every step; the DPM step is within 4e-6 of max |z| over a whole chained
schedule (XLA's own expm1 and division; measured 1.0e-6 over 50 steps).
``aux_noise``'s bits are JAX's; its normals within 3 float32 ulps (the base
noise's bound, ``tests/test_torch_rng_scheduler.py``). ``generate`` rounds
eps and z to bf16 leaves, so a 1e-7 difference can flip one bf16 rounding,
which the chain carries: z within 0.0625, eps within 0.0625 over 3 steps
(measured 0.0039 / 0.0098), z_0 bit-equal and >= 95% of z bit-equal, frames
within 2 levels.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvdx_tpu.models.dit_video import VideoDiT as JVideoDiT
from dvdx_tpu.models.dit_video import _rope_3d as j_rope_3d
from dvdx_tpu.models.dit_video import init_dit_params
from dvdx_tpu.models.dit_video import tiny_dit_config as j_tiny_dit
from dvdx_tpu.models.zoo import REGISTRY as J_REGISTRY
from dvdx_tpu.ops import rng as jrng
from dvdx_tpu.ops import scheduler as jsched
from dvdx_tpu.pipelines.text2video import build_pipeline as jbuild_pipeline
from dvdx_tpu.pipelines.text2video import generate as jgenerate
from dvdx_tpu.utils.testing import perturb_zero_params as jperturb
from dvdx_tpu_torch.models.dit_video import VideoDiT, rope_3d, tiny_dit_config
from dvdx_tpu_torch.models.zoo import REGISTRY, get_model_spec
from dvdx_tpu_torch.network.mock import build_mock_network
from dvdx_tpu_torch.network.validator import ValidatorConfig
from dvdx_tpu_torch.ops import rng as trng
from dvdx_tpu_torch.ops import scheduler as tsched
from dvdx_tpu_torch.pipelines.text2video import build_pipeline, empty_pipeline, generate
from dvdx_tpu_torch.utils.bridge import load_jax_params, load_pipeline_params
from dvdx_tpu_torch.utils.testing import perturb_zero_params
from dvdx_tpu_torch.verify.spotcheck import StepEngine, verify_revealed_steps
from tests.test_torch_network_rounds import _cross_round, honest_or_known_refusal

torch.set_num_threads(2)

PROMPT = "a spinning galaxy"
GEN = dict(seed=4, num_frames=2, height=32, width=32, num_steps=3)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _report(what, got, want):
    got, want = _f32(got), _f32(want)
    print(f"{what}: max_abs_err {np.abs(got - want).max():.3g}, "
          f"max_abs_ref {np.abs(want).max():.3g}")  # shown by pytest -rP


@pytest.fixture(scope="module")
def dit_pipes():
    """(the reference's dit-tiny with perturbed zero leaves, the port's
    dit-tiny holding the same weights)."""
    ref = jbuild_pipeline("dit-tiny", seed=0)
    ref.params = jperturb(ref.params, seed=99)
    port = build_pipeline("dit-tiny", device="cpu")
    return ref, load_pipeline_params(port, jax.tree.map(np.asarray, ref.params))


# --- the model ------------------------------------------------------------


@pytest.mark.parametrize("dim", [64, 48, 30])
def test_rope_3d_matches_reference(dim):
    rng = np.random.default_rng(dim)
    pf, ph, pw = (rng.integers(0, 60, 37) for _ in range(3))
    want = j_rope_3d(jnp.asarray(pf), jnp.asarray(ph), jnp.asarray(pw), dim)
    got = rope_3d(torch.from_numpy(pf), torch.from_numpy(ph), torch.from_numpy(pw), dim)
    for g, w in zip(got, want):
        assert g.shape == (37, dim // 2) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-7, rtol=0)


@pytest.mark.parametrize("positions", [None, (3, 4, 5, 6)])
def test_video_dit_matches_reference(positions):
    """dit-tiny's call on bridged flax-initialised weights (zero leaves
    perturbed), with and without absolute frame positions (a chunk of a
    longer clip)."""
    cfg = j_tiny_dit()
    params = jperturb(init_dit_params(cfg), seed=3)
    port = load_jax_params(VideoDiT(tiny_dit_config()), jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(0)
    lat = rng.normal(size=(2, 4, 16, 16, 4)).astype(np.float32)
    ctx = rng.normal(size=(2, 8, 64)).astype(np.float32)
    ts = np.array([500, 21], np.int32)
    pos = None if positions is None else np.asarray(positions)
    want = np.asarray(jax.jit(JVideoDiT(cfg).apply)(params, lat, ts, ctx, pos))
    with torch.no_grad():
        got = port(torch.from_numpy(lat), torch.from_numpy(ts), torch.from_numpy(ctx),
                   None if pos is None else torch.from_numpy(pos)).numpy()
    _report("VideoDiT", got, want)
    assert got.shape == lat.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_dit_zero_init_is_identity_and_text_flows():
    """The port's own seeded init: adaLN-zero and proj_out_zero make the
    output 0; with the zero leaves perturbed, the text context moves it."""
    pipe = build_pipeline("dit-tiny", seed=1, device="cpu")
    lat = torch.randn(1, 2, 16, 16, 4, generator=torch.Generator().manual_seed(0))
    ts = torch.tensor([500])
    ctx = [torch.randn(1, 8, 64, generator=torch.Generator().manual_seed(s)) for s in (1, 2)]
    with torch.no_grad():
        assert not pipe.unet(lat, ts, ctx[0]).any()
        perturb_zero_params(pipe, seed=3)
        a, b = (pipe.unet(lat, ts, c) for c in ctx)
    assert a.shape == lat.shape and not torch.allclose(a, b)


def test_pipeline_device_reads_any_denoiser():
    assert build_pipeline("dit-tiny", device="cpu").device == torch.device("cpu")
    assert build_pipeline("zeroscope-tiny", device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("name", sorted(J_REGISTRY))
def test_zoo_specs_match_reference(name):
    """Every registered family's spec, field for field (dtypes by name). The
    reference's UNet config has one switch the port lacks,
    ``use_temporal_attention``, which is on in every family (the port's
    UNet always has its temporal transformers)."""
    def fields(spec):
        out = {}
        for f in dataclasses.fields(spec):
            v = getattr(spec, f.name)
            out[f.name] = dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
        return out

    got, want = fields(get_model_spec(name)), fields(J_REGISTRY[name])
    if want["unet"] is not None:
        assert want["unet"].pop("use_temporal_attention") is True
    assert got == want
    assert get_model_spec(name).latent_channels == J_REGISTRY[name].latent_channels
    assert set(REGISTRY) == set(J_REGISTRY)


def test_cogvideox_tree_matches_reference_at_full_size():
    """cogvideox-5b at full width and depth, without weights: the port's
    parameters (on the meta device) are the reference's abstract flax tree
    leaf for leaf through the bridge's layouts, denoiser and text tower
    (4096 wide, 24 layers, 32 heads, 226 tokens)."""
    from dvdx_tpu.models.text_encoder import CLIPTextEncoder as JText

    spec = get_model_spec("cogvideox-5b")
    jspec = J_REGISTRY["cogvideox-5b"]
    with torch.device("meta"):
        port = empty_pipeline(spec, device="meta")
    trees = {
        "unet": jax.eval_shape(JVideoDiT(jspec.dit).init, jax.random.key(0),
                               jnp.zeros((1, 2, 4, 4, 16), jnp.bfloat16),
                               jnp.zeros((1,), jnp.int32),
                               jnp.zeros((1, 8, 4096), jnp.bfloat16)),
        "text": jax.eval_shape(JText(jspec.text).init, jax.random.key(0),
                               jnp.zeros((1, 226), jnp.int32))}
    for key, module in (("unet", port.unet), ("text", port.text_encoder)):
        leaves = jax.tree_util.tree_flatten_with_path(trees[key])[0]
        params = dict(module.named_parameters())
        assert len(leaves) == len(params), key
        for path, leaf in leaves:
            names = [p.key for p in path if p.key != "params"]
            name = ".".join(names[:-1] + [{"kernel": "weight", "scale": "weight",
                                           "embedding": "weight"}.get(names[-1], names[-1])])
            shape = tuple(params[name].shape)
            if names[-1] == "kernel":
                shape = shape[::-1]
            assert shape == tuple(leaf.shape), name
    n_dit = sum(p.numel() for p in port.unet.parameters())
    n_text = sum(p.numel() for p in port.text_encoder.parameters())
    print(f"cogvideox-5b: DiT {n_dit / 1e9:.3f} B, text tower {n_text / 1e9:.3f} B "
          "parameters")  # shown by pytest -rP
    assert 7.0e9 < n_dit < 7.3e9 and 3.5e9 < n_text < 4.0e9


def test_cogvideox_text_tower_layer_matches_reference():
    """cogvideox-5b's text tower at its full width (4096, 32 heads of 128,
    MLP 10240, 226 positions) cut to one layer and a 1024-token vocabulary
    (float32), against the JAX tower on the same weights."""
    from dvdx_tpu.models.text_encoder import CLIPTextEncoder as JText
    from dvdx_tpu_torch.models.text_encoder import CLIPTextEncoder

    cfg = dataclasses.replace(J_REGISTRY["cogvideox-5b"].text, num_layers=1,
                              vocab_size=1024, dtype="float32")
    rng = np.random.default_rng(5)
    ids = rng.integers(3, 1024, (1, 226)).astype(np.int32)
    ids[0, 40] = 2  # EOS
    shapes = jax.eval_shape(JText(cfg).init, jax.random.key(0), jnp.asarray(ids))
    params = jax.tree.map(lambda s: (rng.normal(size=s.shape) * (s.shape[0] ** -0.5
                                                                   if len(s.shape) == 2
                                                                   else 0.1)
                                     ).astype(np.float32), shapes)
    want_h, want_p = jax.jit(JText(cfg).apply)(params, ids)
    tcfg = dataclasses.replace(get_model_spec("cogvideox-5b").text, num_layers=1,
                               vocab_size=1024, dtype="float32")
    port = load_jax_params(CLIPTextEncoder(tcfg), params)
    with torch.no_grad():
        got_h, got_p = port(torch.from_numpy(ids).long())
    _report("cogvideox text layer", got_h, want_h)
    assert got_h.shape == (1, 226, 4096)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-4, rtol=0)


# --- schedules and noise ---------------------------------------------------


@pytest.mark.parametrize("num_steps", [4, 25, 50])
def test_v_prediction_ddim_step_matches_reference(num_steps):
    sched_j = jsched.make_ddim_schedule(num_steps, prediction_type="v_prediction")
    sched_t = tsched.make_ddim_schedule(num_steps, prediction_type="v_prediction")
    rng = np.random.default_rng(num_steps)
    z = (rng.normal(size=(1, 4, 6, 6, 16)) * 3).astype(np.float32)
    v = rng.normal(size=z.shape).astype(np.float32)
    step = jax.jit(lambda zz, vv, i: jsched.ddim_step(sched_j, i, zz, vv))
    for i in range(num_steps):
        want = np.asarray(step(jnp.asarray(z), jnp.asarray(v), i))
        got = tsched.ddim_step(sched_t, i, torch.from_numpy(z), torch.from_numpy(v))
        np.testing.assert_array_equal(got.numpy(), want)
    eps_step = tsched.ddim_step(tsched.make_ddim_schedule(num_steps), 1,
                                torch.from_numpy(z), torch.from_numpy(v))
    assert not torch.equal(eps_step, tsched.ddim_step(sched_t, 1, torch.from_numpy(z),
                                                      torch.from_numpy(v)))


def test_v_prediction_ddim_step_bfloat16_matches_reference():
    sched_j = jsched.make_ddim_schedule(25, prediction_type="v_prediction")
    sched_t = tsched.make_ddim_schedule(25, prediction_type="v_prediction")
    rng = np.random.default_rng(1)
    z = (rng.normal(size=(1, 2, 4, 4, 16)) * 3).astype(np.float32)
    v = rng.normal(size=z.shape).astype(np.float32)
    step = jax.jit(lambda zz, vv, i: jsched.ddim_step(sched_j, i, zz, vv))
    for i in range(25):
        want = np.asarray(step(jnp.asarray(z, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
                               i).astype(jnp.float32))
        got = tsched.ddim_step(sched_t, i, torch.from_numpy(z).bfloat16(),
                               torch.from_numpy(v).bfloat16())
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("num_steps", [4, 25, 50])
def test_dpm_tables_equal(num_steps):
    want, got = jsched.make_dpm_schedule(num_steps), tsched.make_dpm_schedule(num_steps)
    for name in ("timesteps", "alphas_cumprod", "lambdas", "sigmas", "alphas"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)))
    assert got.num_steps == num_steps


@pytest.mark.parametrize("num_steps", [4, 25, 50])
def test_dpm_step_chain_matches_reference(num_steps):
    """A whole DPM-Solver++(2M) schedule, each side fed its own z and x0 and
    the same eps per step; the last step returns x0."""
    sched_j, sched_t = jsched.make_dpm_schedule(num_steps), tsched.make_dpm_schedule(num_steps)
    rng = np.random.default_rng(7)
    z0 = (rng.normal(size=(1, 4, 6, 6, 4)) * 3).astype(np.float32)
    step = jax.jit(lambda zz, ee, px, i: jsched.dpm_step(sched_j, i, zz, ee, px))
    zj, xj = jnp.asarray(z0), jnp.asarray(z0)
    zt, xt = torch.from_numpy(z0), torch.from_numpy(z0)
    worst = 0.0
    for i in range(num_steps):
        e = rng.normal(size=z0.shape).astype(np.float32)
        zj, xj = step(zj, jnp.asarray(e), xj, i)
        zt, xt = tsched.dpm_step(sched_t, i, zt, torch.from_numpy(e), xt)
        want = np.asarray(zj)
        err = np.abs(zt.numpy() - want).max() / np.abs(want).max()
        worst = max(worst, err)
        assert err <= 4e-6, (i, err)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                                   atol=4e-6 * np.abs(np.asarray(xj)).max())
    print(f"dpm {num_steps} steps: worst relative error {worst:.3g}")  # pytest -rP
    np.testing.assert_array_equal(zt.numpy(), xt.numpy())


@pytest.mark.parametrize("tag", [0, 7, 123])
def test_aux_noise_matches_reference(tag):
    key = 2 ** 40 + 77
    x = np.zeros((4, 4, 16), np.float32)
    want = np.asarray(jrng.aux_noise(jrng.base_key(key), jnp.asarray(x), tag))
    got = trng.aux_noise(trng.base_key(key), torch.from_numpy(x), tag).numpy()
    salted = trng.fold_in(trng.fold_in(trng.base_key(key), trng.AUX_SALT), tag)
    want_key = jax.random.fold_in(jax.random.fold_in(jrng.base_key(key),
                                                     jnp.uint32(jrng.AUX_SALT)),
                                  jnp.uint32(tag))
    assert salted.tolist() == [int(w) for w in np.asarray(jax.random.key_data(want_key))]
    bits = trng.random_bits(salted, x.shape, device="cpu").numpy()
    np.testing.assert_array_equal(
        bits, np.asarray(jax.random.bits(want_key, x.shape, jnp.uint32)).astype(np.int64))
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert ulps.max() <= 3
    frame = trng.frame_noise(trng.base_key(key), tag, x.shape, device="cpu").numpy()
    assert not np.array_equal(got, frame)  # the salt keeps the streams apart


# --- the family through the pipeline, StepEngine and the network ------------


def test_generate_matches_reference(dit_pipes):
    ref, port = dit_pipes
    vj, (zj, ej, tj) = jgenerate(ref, PROMPT, record=True, **GEN)
    vt, (zt, et, tt) = generate(port, PROMPT, record=True, **GEN)
    np.testing.assert_array_equal(tt, tj)
    assert zt.shape == zj.shape == (3, 1, 2, 16, 16, 4) and zt.dtype == torch.bfloat16
    assert vt.shape == vj.shape == (2, 32, 32, 3) and vt.dtype == np.uint8
    np.testing.assert_array_equal(_f32(zt[0]), _f32(zj[0]))
    _report("generate z", zt, zj)
    _report("generate eps", et, ej)
    np.testing.assert_allclose(_f32(zt), _f32(zj), atol=0.0625, rtol=0)
    np.testing.assert_allclose(_f32(et), _f32(ej), atol=0.0625, rtol=0)
    assert (_f32(zt) == _f32(zj)).mean() >= 0.95
    assert np.abs(vt.astype(int) - vj.astype(int)).max() <= 2
    assert np.abs(_f32(et)).max() > 0.1  # the perturbed DiT carries signal


def test_generate_is_deterministic(dit_pipes):
    _, port = dit_pipes
    a = generate(port, PROMPT, record=True, **GEN)
    b = generate(port, PROMPT, record=True, **GEN)
    assert np.array_equal(a[0], b[0])
    assert torch.equal(a[1][0], b[1][0]) and torch.equal(a[1][1], b[1][1])


def test_step_engine_reexecutes_dit_bitwise(dit_pipes):
    """The DiT's recorded steps re-execute bit for bit on one platform; the
    base latent has the family's channels; a tampered eps is refused."""
    _, port = dit_pipes
    eng = StepEngine(port)
    geo = dict(num_frames=2, height=32, width=32, num_steps=3, guidance_scale=6.0)
    video, zs, epss, ts = eng.generate_recorded(PROMPT, seed=9, **geo)
    assert zs.shape == (3, 2, 16, 16, 4) and video.shape == (2, 32, 32, 3)
    assert torch.equal(eng.base_latent(9, 2, 32, 32).view(torch.int16),
                       zs[0].view(torch.int16))
    leaves = {i: (int(ts[i]), zs[i], epss[i]) for i in range(3)}
    res, _ = verify_revealed_steps(eng, PROMPT, "", leaves, [0, 1, 2], 3, 6.0,
                                   same_platform=True, atol=1e-4, rtol=2 ** -7)
    assert all(r.passed and r.bitwise for r in res.values())
    ok, err = eng.verify_video_binding(video, leaves[2], 2, 3, 6.0, PROMPT,
                                       frame_indices=(0, 1))
    assert ok and err < 0.02
    leaves[1] = (leaves[1][0], zs[1], epss[1] + 0.25)
    res, _ = verify_revealed_steps(eng, PROMPT, "", leaves, [1], 3, 6.0,
                                   same_platform=True, atol=1e-4, rtol=2 ** -7)
    assert not res[1].passed


def test_dit_family_poi_round(dit_pipes, tmp_path):
    """The port of the reference's ``test_dit_family_poi_round``: a round
    over the v-prediction DiT on the port's mock network, the honest miner
    bitwise with the base-noise binding, and a lazy miner caught."""
    _, port = dit_pipes
    cfg = ValidatorConfig(sample_size=2, num_checkpoints=2, num_frames=2, width=32,
                          height=32, num_steps=3, guidance_scale=6.0, ping_timeout_s=30,
                          results_dir=str(tmp_path))
    net = build_mock_network(n_miners=2, adversaries=["honest", "lazy"], pipeline=port,
                             validator_config=cfg, device="cpu")
    loop = asyncio.new_event_loop()
    try:
        report = loop.run_until_complete(net.run_request("dit-poi", "a drifting nebula"))
    finally:
        loop.close()
    d = report["miners"]["0"]
    assert d["checks"]["reexecution"] is True and d.get("reexec_bitwise") is True
    assert d["checks"].get("base_noise") is True and d["checks"]["video_binding"]
    assert d["score"] > 0 and not d.get("cheat", False)
    lazy = report["miners"]["1"]
    assert lazy["failed_check"] == "reexecution" and lazy["cheat"] is True


@pytest.mark.parametrize("torch_validator", [False, True])
def test_dit_round_across_implementations(dit_pipes, torch_validator, tmp_path):
    """A dit-tiny miner of one package behind the other package's validator,
    every message crossing as wire bytes: the honest miner passes in the
    cross-platform regime (or meets ROADMAP §3.1's refusal, printed), the
    lazy one is caught."""
    ref, port = dit_pipes
    miner_pipe, validator_pipe = (ref, port) if torch_validator else (port, ref)
    r = _cross_round(miner_pipe, validator_pipe, torch_validator, tmp_path,
                     f"dit-x-{torch_validator}", guidance_scale=6.0)
    report = r.report
    lazy = report["miners"]["1"]
    assert lazy["failed_check"] == "reexecution" and lazy["cheat"] is True, lazy
    d = report["miners"]["0"]
    if not honest_or_known_refusal(r, f"dit round, torch validator {torch_validator}"):
        return
    assert all(d["checks"].values()) and d["checks"]["video_binding"]
    assert d["same_platform"] is False and d["regime_atol"] == 5e-2
    print(f"dit round, torch validator {torch_validator}: reexec_max_err "
          f"{d['reexec_max_err']:.4g}")  # pytest -rP
    assert d["score"] > 0.0
