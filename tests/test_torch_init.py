"""One registry name, one model: the port's seeded weights against the JAX
package's.

* ``utils.init.fast_init`` (through ``pipelines.text2video.build_pipeline``,
  ``pipelines.img2video.build_img2video_pipeline`` and
  ``scoring.clip_score.CLIPScorer.build``) against
  ``dvdx_tpu.utils.init.fast_init`` leaf by leaf, bit for bit (tolerance 0),
  for zeroscope-tiny, zeroscope-tiny-hf, dit-tiny, svd-tiny (with its VAE
  encoder), a bf16 zeroscope-tiny and the tiny CLIP scorer's towers;
* ``utils.testing.perturb_zero_params`` and the two ``amplify_*`` against
  the JAX ones on the whole pipeline tree, bit for bit;
* the bridge's inverse (``utils.bridge.flax_leaves``): the JAX tree's paths,
  order and shapes, and a round trip through ``load_jax_params``;
* ``utils.init.tree_digest`` against the same digest of the JAX tree, and
  (``slow``) the full-width constant ``REFERENCE_DIGESTS`` recomputed with
  the JAX package leaf by leaf;
* a ``python -m dvdx_tpu.network.services --cpu validator`` process and a
  ``python -m dvdx_tpu_torch miner --cpu`` process, both ``--model
  zeroscope-tiny --perturb``, run a round over HTTP: the honest port miner
  passes, or meets exactly the cross-platform refusal of ROADMAP §3.1.
"""

import asyncio
import dataclasses
import hashlib
import os
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from dvdx_tpu.models.text_encoder import CLIPTextEncoder as JText
from dvdx_tpu.models.unet3d import UNet3D as JUNet
from dvdx_tpu.models.vae import VAEDecoder as JVAEDecoder
from dvdx_tpu.models.zoo import get_model_spec as jspec
from dvdx_tpu.pipelines.img2video import build_img2video_pipeline as jbuild_i2v
from dvdx_tpu.pipelines.text2video import build_pipeline as jbuild
from dvdx_tpu.scoring.clip_score import CLIPScorer as JScorer
from dvdx_tpu.utils import init as jinit
from dvdx_tpu.utils import testing as jtesting
from dvdx_tpu_torch.models.zoo import get_model_spec
from dvdx_tpu_torch.pipelines.img2video import build_img2video_pipeline
from dvdx_tpu_torch.pipelines.text2video import build_pipeline
from dvdx_tpu_torch.scoring.clip_score import CLIPScorer
from dvdx_tpu_torch.utils import init, testing
from dvdx_tpu_torch.utils.bridge import flax_leaves, load_jax_params, load_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["zeroscope-tiny", "zeroscope-tiny-hf", "dit-tiny"]


def _bits(a) -> np.ndarray:
    """A leaf's raw bits (bf16 / float32 as unsigned ints)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def differing(jtree, port) -> list:
    """Paths of the leaves that differ in bits, shape or order between the
    JAX tree and the port object's flax view (empty: every leaf equal)."""
    jl = tree_flatten_with_path(jtree)[0]
    pl = flax_leaves(port)
    assert [tuple(k.key for k in p) for p, _ in jl] == [leaf.path for leaf in pl]
    out = []
    for (path, want), leaf in zip(jl, pl):
        got = leaf.to_flax(leaf.param.detach())
        want = np.asarray(want)
        if tuple(got.shape) != want.shape or not np.array_equal(_bits(got), _bits(want)):
            out.append(keystr(path))
    return out


def _bf16_spec(name):
    """The registry spec with every module in bfloat16 (the port's modules
    take their dtype from the spec; the JAX package casts to params_dtype)."""
    spec = get_model_spec(name)
    return dataclasses.replace(
        spec, unet=dataclasses.replace(spec.unet, dtype="bfloat16"),
        text=dataclasses.replace(spec.text, dtype="bfloat16"),
        vae=dataclasses.replace(spec.vae, dtype="bfloat16"))


# --- fast_init and perturb_zero_params, bit for bit ----------------------------------


@pytest.mark.parametrize("name", FAMILIES)
def test_fast_init_equals_jax(name):
    assert differing(jbuild(name, seed=3).params, build_pipeline(name, seed=3, device="cpu")) == []


@pytest.mark.parametrize("name", FAMILIES)
def test_perturb_equals_jax_on_the_whole_tree(name):
    """ROADMAP §3.4's count (307 of 371 zeroscope-tiny tensors differing
    while the port drew its own weights) is 0."""
    ref = jbuild(name, seed=0)
    ref.params = jtesting.perturb_zero_params(ref.params, seed=99)
    port = testing.perturb_zero_params(build_pipeline(name, seed=0, device="cpu"), seed=99)
    assert differing(ref.params, port) == []


def test_bf16_init_and_perturb_equal_jax():
    """bf16 leaves: float32 draws cast once (round to nearest even), and the
    perturbation's float64 noise cast as ml_dtypes casts it."""
    ref = jbuild("zeroscope-tiny", seed=1, params_dtype=jnp.bfloat16)
    port = build_pipeline(_bf16_spec("zeroscope-tiny"), seed=1, device="cpu")
    assert next(port.unet.parameters()).dtype == torch.bfloat16
    assert differing(ref.params, port) == []
    ref.params = jtesting.perturb_zero_params(ref.params, seed=99)
    testing.perturb_zero_params(port, seed=99)
    assert differing(ref.params, port) == []


def test_svd_tiny_with_its_encoder_equals_jax():
    ref = jbuild_i2v("svd-tiny", seed=2)
    port = build_img2video_pipeline("svd-tiny", seed=2, device="cpu")
    assert set(ref.base.params) == set(port.flax_trees()) == {"unet", "text", "vae_dec",
                                                              "vae_enc"}
    assert differing(ref.base.params, port) == []
    ref.base.params = jtesting.perturb_zero_params(ref.base.params, seed=99)
    assert differing(ref.base.params, testing.perturb_zero_params(port, seed=99)) == []


@pytest.mark.parametrize("seed", [1234, 7])
def test_clip_scorer_towers_equal_jax(seed):
    ref, port = JScorer.build(seed=seed), CLIPScorer.build(seed=seed, device="cpu")
    assert differing(ref.params, port) == []


def test_float64_noise_rounds_to_bf16_as_ml_dtypes():
    """1 + 2^-8 + 2^-30 rounds to 1 through float32 (a tie, to even) and to
    1 + 2^-7 in one rounding: perturb_zero_params must take the first, as
    ml_dtypes does."""
    x = np.array([1 + 2 ** -8 + 2 ** -30, -(1 + 2 ** -8 + 2 ** -30), 3e-39, 1e-45])
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).view(torch.int16)
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want)
    assert want[0] == np.array(1.0, ml_dtypes.bfloat16).view(np.uint16)


@pytest.mark.parametrize("gain,which", [(8.0, "temporal"), (3.7, "output"), (0.3, "temporal")])
@pytest.mark.parametrize("name", ["zeroscope-tiny", "zeroscope-tiny-hf"])
def test_amplify_equals_jax(name, gain, which):
    ref = jbuild(name, seed=0)
    ref.params = jtesting.perturb_zero_params(ref.params, seed=99)
    port = testing.perturb_zero_params(build_pipeline(name, seed=0, device="cpu"), seed=99)
    jfn = jtesting.amplify_temporal_params if which == "temporal" \
        else jtesting.amplify_output_params
    fn = testing.amplify_temporal_params if which == "temporal" \
        else testing.amplify_output_params
    before = init.tree_digest(port)
    assert differing(jfn(ref.params, gain), fn(port, gain)) == []
    assert init.tree_digest(port) != before


# --- the bridge's inverse ---------------------------------------------------------------


@pytest.mark.parametrize("name", FAMILIES + ["svd-tiny", "scorer"])
def test_bridge_round_trips_every_family(name):
    """Every leaf out through ``to_flax`` and back through the forward
    bridge lands on its own parameter, bit for bit; every flax shape is the
    JAX tree's."""
    if name == "scorer":
        src, ref = CLIPScorer.build(seed=5, device="cpu"), JScorer.build(seed=5).params
        dst = CLIPScorer.build(seed=6, device="cpu")
    elif name == "svd-tiny":
        src, ref = (build_img2video_pipeline(name, seed=5, device="cpu"),
                    jbuild_i2v(name, seed=5).base.params)
        dst = build_img2video_pipeline(name, seed=6, device="cpu")
    else:
        src, ref = build_pipeline(name, seed=5, device="cpu"), jbuild(name, seed=5).params
        dst = build_pipeline(name, seed=6, device="cpu")
    src = testing.perturb_zero_params(src, seed=1)
    shapes = {tuple(k.key for k in p): np.shape(v) for p, v in tree_flatten_with_path(ref)[0]}
    tree = {}
    for leaf in flax_leaves(src):
        assert leaf.shape == shapes[leaf.path], leaf.path
        node = tree
        for k in leaf.path[:-1]:
            node = node.setdefault(k, {})
        node[leaf.path[-1]] = leaf.to_flax(leaf.param.detach()).contiguous()
    assert init.tree_digest(dst) != init.tree_digest(src)
    load_tree(dst, tree)
    assert init.tree_digest(dst) == init.tree_digest(src)


def test_bridge_refuses_a_wrong_leaf_name():
    unet = build_pipeline("zeroscope-tiny", device="cpu").unet
    w = unet.conv_in.weight.detach()
    with pytest.raises(TypeError, match="layout"):
        load_jax_params(unet, {"params": {"conv_in": {"scale": w}}})


# --- digests and counts -----------------------------------------------------------------


def jax_tree_digest(name: str, seed: int = 0, perturb_seed=99) -> tuple:
    """(sha256 over the JAX package's leaves of build_pipeline(name, seed)
    perturbed at ``perturb_seed``, in tree order, parameter count), leaf by
    leaf with ``dvdx_tpu.utils.init._leaf_array`` over ``jax.eval_shape``'s
    shapes: the whole tree is never held."""
    spec = jspec(name)
    dt = jnp.dtype(spec.denoiser_config.compute_dtype)
    u = spec.unet
    trees = {
        "unet": (jax.eval_shape(lambda: JUNet(u).init(
            jax.random.key(0), jnp.zeros((1, 2, 16, 16, u.in_channels), dt),
            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 8, u.cross_attention_dim), dt))), seed),
        "text": (jax.eval_shape(lambda: JText(spec.text).init(
            jax.random.key(0), jnp.zeros((1, spec.text.max_length), jnp.int32))), seed + 1),
        "vae_dec": (jax.eval_shape(lambda: JVAEDecoder(spec.vae).init(
            jax.random.key(0), jnp.zeros((1, 8, 8, spec.vae.latent_channels)))), seed + 2),
    }
    h, n = hashlib.sha256(), 0
    for i, (path, sds) in enumerate(tree_flatten_with_path({k: t for k, (t, _) in
                                                            trees.items()})[0]):
        keys = [p.key for p in path]
        leaf = jinit._leaf_array("/".join(keys[1:]), sds, trees[keys[0]][1])
        if leaf.dtype == np.float32 and dt != np.float32:
            leaf = leaf.astype(dt)
        if perturb_seed is not None and leaf.size and not leaf.any():
            leaf = np.random.default_rng(perturb_seed * 100003 + i).normal(
                0.0, 0.02, leaf.shape).astype(leaf.dtype)
        h.update(np.ascontiguousarray(leaf).tobytes())
        n += leaf.size
    return h.hexdigest(), n


@pytest.mark.parametrize("name", ["zeroscope-tiny", "zeroscope-tiny-hf"])
def test_tree_digest_equals_the_jax_leaf_by_leaf_digest(name):
    port = testing.perturb_zero_params(build_pipeline(name, seed=0, device="cpu"), seed=99)
    digest, n = jax_tree_digest(name)
    assert init.tree_digest(port) == digest and init.param_count(port) == n


@pytest.mark.slow
def test_full_width_digest_constant_is_the_jax_packages():
    """The constant chip_smoke.py phase 11 holds the card's weights to:
    zeroscope-v2-576w (1.8 B parameters, bf16) recomputed with the JAX
    package leaf by leaf (about 40 s and a few hundred MB on a CPU)."""
    digest, n = jax_tree_digest("zeroscope-v2-576w", 0, 99)
    assert digest == init.REFERENCE_DIGESTS[("zeroscope-v2-576w", 0, 99)]
    assert n == 1_797_790_683


def test_param_count_and_bytes_equal_jax():
    ref = jbuild("dit-tiny", seed=0)
    port = build_pipeline("dit-tiny", seed=0, device="cpu")
    assert init.param_count(port) == jinit.param_count(ref.params)
    assert init.param_bytes(port) == jinit.param_bytes(ref.params)
    assert init.param_count(port) == sum(p.numel() for p in port.parameters())


def test_fast_init_is_independent_of_its_threads(monkeypatch):
    a = init.tree_digest(build_pipeline("zeroscope-tiny-hf", seed=4, device="cpu"))
    monkeypatch.setattr(init, "DRAW_WORKERS", 1)
    assert init.tree_digest(build_pipeline("zeroscope-tiny-hf", seed=4, device="cpu")) == a


def test_fast_init_rules():
    """Zeros for biases and ``*_zero`` layers, ones for norm scales, and the
    draws' scales: lecun over the flax fan-in, 0.02 for embeddings."""
    pipe = build_pipeline("zeroscope-tiny", seed=0, device="cpu")
    for leaf in flax_leaves(pipe):
        p, name = leaf.param.detach(), leaf.path[-1]
        if any("_zero" in k for k in leaf.path) or name == "bias":
            assert not p.any(), leaf.path
        elif name == "scale":
            assert (p == 1).all(), leaf.path
        elif p.numel() > 4096:
            std = float(p.float().std())
            want = 0.02 if "embedding" in name else np.prod(leaf.shape[:-1]) ** -0.5
            assert abs(std / want - 1) < 0.05, (leaf.path, std, want)


# --- the repair, as processes: a JAX validator and a port miner -------------------------


def _wait_for(proc, log, pattern: str, deadline_s: float) -> re.Match:
    deadline = time.time() + deadline_s
    while True:
        m = re.search(pattern, log.read_text(errors="replace"))
        if m:
            return m
        assert proc.poll() is None, log.read_text(errors="replace")[-4000:]
        assert time.time() < deadline, log.read_text(errors="replace")[-4000:]
        time.sleep(0.2)


def _stop(*procs):
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=20)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=20)


def test_jax_validator_process_and_port_miner_process_share_a_model(tmp_path):
    """Before the repair every such round was refused: the two packages
    derived different weights from one registry name. Now the honest port
    miner passes, or is refused exactly at ROADMAP §3.1's cross-platform
    bound, located as ``honest_or_known_refusal`` locates it: the JAX
    validator's re-execution is run again here on the leaves the miner
    spooled, and every element beyond the bound must be one bf16 ulp
    apart at |z| >= 8 on both sides."""
    from types import SimpleNamespace

    from aiohttp import ClientSession, ClientTimeout

    from dvdx_tpu.network.validator import ValidatorConfig as JValidatorConfig
    from dvdx_tpu.verify.spotcheck import StepEngine as JStepEngine
    from tests.test_torch_network_rounds import CrossRound, honest_or_known_refusal
    from tests.test_torch_services import _poll_json

    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=1"}
    (tmp_path / "v").mkdir()
    (tmp_path / "m").mkdir()
    vlog, mlog = tmp_path / "v" / "log", tmp_path / "m" / "log"
    with open(vlog, "w") as out:
        val = subprocess.Popen(
            [sys.executable, "-m", "dvdx_tpu.network.services", "--cpu", "validator",
             "--model", "zeroscope-tiny", "--perturb", "--api-port", "0", "--width", "32",
             "--height", "32", "--frames", "2", "--steps", "3", "--sample-size", "1",
             "--num-checkpoints", "2", "--poll-interval", "0.1",
             "--results-dir", str(tmp_path / "v" / "results")],
            cwd=str(tmp_path / "v"), stdout=out, stderr=subprocess.STDOUT, env=env)
    procs = [val]
    try:
        port = int(_wait_for(val, vlog, r"REST API at 127\.0\.0\.1:(\d+)", 240)[1])
        with open(mlog, "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "dvdx_tpu_torch", "miner", "--cpu", "--model",
                 "zeroscope-tiny", "--perturb", "--port", "0", "--validator-api",
                 f"127.0.0.1:{port}", "--sync-interval", "0.2", "--spool-dir",
                 str(tmp_path / "m" / "spool")],
                cwd=str(tmp_path / "m"), stdout=out, stderr=subprocess.STDOUT, env=env))
        _wait_for(procs[1], mlog, r"serving at", 120)

        prompt = "a red ball bouncing"

        async def go():
            base = f"http://127.0.0.1:{port}"
            async with ClientSession(timeout=ClientTimeout(total=60)) as sess:
                reg = await _poll_json(sess, f"{base}/registry", lambda b: any(
                    n["role"] == "miner" for n in b.values()), 60)  # the miner's first sync
                async with sess.post(f"{base}/deposit", json={
                        "user": "u", "request_id": "x-1", "amount": 1000,
                        "prompt_hash": hashlib.sha256(prompt.encode()).hexdigest()}) as r:
                    assert r.status == 200
                async with sess.post(f"{base}/submit_prompt", json={
                        "request_id": "x-1", "prompt": prompt}) as r:
                    assert r.status == 200
                status = await _poll_json(sess, f"{base}/status/x-1", lambda b: b.get(
                    "status") in ("completed", "failed"), 240)
                async with sess.get(f"{base}/result/x-1") as r:
                    return reg, status, await r.json()

        reg, status, result = asyncio.new_event_loop().run_until_complete(
            asyncio.wait_for(go(), 400))
    finally:
        _stop(*reversed(procs))
    (uid, d), = result["miners"].items()
    assert reg[uid]["platform"] == "torch-cpu"
    assert d["same_platform"] is False and d["regime_atol"] == 5e-2
    # the round as honest_or_known_refusal reads it: the miner's committed
    # trace (its spool), and the JAX validator's engine and configuration
    with np.load(tmp_path / "m" / "spool" / "trace_x-1.npz") as t:
        com = SimpleNamespace(timesteps=t["timesteps"], zs=t["zs"], epss=t["epss"])
    jpipe = jbuild("zeroscope-tiny", seed=0)
    jpipe.params = jtesting.perturb_zero_params(jpipe.params, seed=99)
    val = SimpleNamespace(engine=JStepEngine(jpipe), config=JValidatorConfig(
        sample_size=1, num_checkpoints=2, width=32, height=32, num_frames=2, num_steps=3))
    r = CrossRound(val, {"request_id": "x-1", "miners": {"0": d}},
                   [SimpleNamespace(_proofs={"x-1": com})], prompt)
    if not honest_or_known_refusal(r, "JAX validator process, port miner process"):
        assert status["status"] == "failed"
        return
    assert all(d["checks"].values()) and d["score"] > 0 and status["status"] == "completed"
    print(f"honest port miner passed the JAX validator: reexec_max_err "
          f"{d['reexec_max_err']:.4g}")  # pytest -rP
