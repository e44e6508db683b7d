"""LPIPS(alex) of the port (``dvdx_tpu_torch/scoring/lpips.py``) against the
JAX package's ``scoring.lpips.LPIPS`` and ``tests/torch_ref.py::LPIPSRef``
(the lpips package's architecture with its exact state-dict keys).

One seeded lpips-package state dict (non-negative ``lin`` heads) is loaded
by both converters; the port's ``convert_lpips`` must give the JAX
converter's arrays bit for bit, and the distances must agree within
TOL = 1e-5 (absolute, float32 on the CPU; the two differ only in the order
of their convolution sums). MD-VQS with ``lpips_metric``: every value within
TOL of the JAX package's, with the CLIP scorer's parameters bridged in.
"""

import jax
import numpy as np
import pytest
import torch

from dvdx_tpu.scoring import clip_score as jclip
from dvdx_tpu.scoring import mdvqs as jm
from dvdx_tpu.scoring.lpips import LPIPS as JLPIPS
from dvdx_tpu.utils import convert as jconvert
from dvdx_tpu_torch.scoring import clip_score as tclip
from dvdx_tpu_torch.scoring import mdvqs as tm
from dvdx_tpu_torch.scoring.lpips import LPIPS
from dvdx_tpu_torch.utils import convert as tconvert
from dvdx_tpu_torch.utils.bridge import load_jax_params, load_lpips_params

TOL = 1e-5


def lpips_state_dict(seed: int = 7) -> dict:
    """A seeded lpips-package ('alex') state dict, as float32 numpy."""
    from tests.torch_ref import LPIPSRef

    ref = LPIPSRef().eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in ref.named_parameters():
            if "lin" in name:
                p.copy_(torch.rand(p.shape, generator=g) * 0.2)
            else:
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return ref, {k: v.detach().float().numpy() for k, v in ref.state_dict().items()}


@pytest.fixture(scope="module")
def models():
    ref, sd = lpips_state_dict()
    jax_lp = JLPIPS(params=jconvert.convert_lpips(sd))
    ours = load_lpips_params(LPIPS(), tconvert.convert_lpips(sd))
    return ref, sd, jax_lp, ours


def _frames(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def test_converter_output_equals_jax_converter(models):
    _, sd, _, _ = models
    ours, ref = tconvert.convert_lpips(sd), jconvert.convert_lpips(sd)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("hw", [(64, 64), (72, 96)])
def test_distance_matches_jax(models, hw):
    _, _, jax_lp, ours = models
    a, b = _frames((3, *hw, 3), 0), _frames((3, *hw, 3), 1)
    want = jax_lp.distance(a, b)
    got = ours.distance(a, b)
    assert np.abs(got - want).max() <= TOL
    np.testing.assert_allclose(ours.distance(a, a), 0.0, atol=1e-7)


def test_distance_matches_lpips_ref(models):
    ref, _, _, ours = models
    a, b = _frames((2, 64, 64, 3), 2), _frames((2, 64, 64, 3), 3)
    with torch.no_grad():
        want = ref(torch.from_numpy(a.transpose(0, 3, 1, 2)),
                   torch.from_numpy(b.transpose(0, 3, 1, 2))).numpy()
    assert np.abs(ours.distance(a, b) - want).max() <= TOL


def test_consecutive_u8_matches_jax_and_f32_path(models):
    _, _, jax_lp, ours = models
    frames = np.random.default_rng(11).integers(0, 256, (5, 64, 64, 3), dtype=np.uint8)
    got = ours.consecutive_mean_u8(frames)
    assert abs(got - jax_lp.consecutive_mean_u8(frames)) <= TOL
    assert abs(got - ours.consecutive_mean(frames.astype(np.float32) / 127.5 - 1.0)) <= 1e-6
    assert ours.consecutive_mean_u8(torch.from_numpy(frames)) == got
    assert ours.consecutive_mean_u8(frames[:1]) == 0.0


def test_random_draws_are_the_jax_packages():
    ref = JLPIPS.random(seed=3)
    ours = LPIPS.random(seed=3, device="cpu")
    bridged = load_lpips_params(LPIPS(), jax.tree.map(np.asarray, ref.params))
    for a, b in zip(ours.state_dict().values(), bridged.state_dict().values()):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(ours.conv0.weight.detach().numpy(),
                                  np.asarray(ref.params["conv0/kernel"]).transpose(3, 2, 0, 1))


def test_converter_is_strict(models):
    _, sd, _, _ = models
    extra = dict(sd, **{"bogus.weight": np.zeros((1,), np.float32)})
    for conv in (tconvert.convert_lpips, jconvert.convert_lpips):
        with pytest.raises(ValueError, match="unconverted"):
            conv(extra)
    missing = {k: v for k, v in sd.items() if k != "lin3.model.1.weight"}
    with pytest.raises(KeyError):
        tconvert.convert_lpips(missing)
    narrow = dict(sd, **{"lin2.model.1.weight": np.zeros((1, 8, 1, 1), np.float32)})
    with pytest.raises(ValueError, match="lin2"):
        tconvert.convert_lpips(narrow)
    # the scaling layer is optional: the package's constants stand in
    bare = {k: v for k, v in sd.items() if not k.startswith("scaling_layer")}
    np.testing.assert_array_equal(tconvert.convert_lpips(bare)["shift"],
                                  np.asarray(jconvert.convert_lpips(bare)["shift"]))


@pytest.mark.parametrize("fmt", ["pth", "safetensors"])
def test_load_lpips_from_files(models, tmp_path, fmt):
    _, sd, jax_lp, _ = models
    path = str(tmp_path / f"alex.{fmt}")
    if fmt == "pth":
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    else:
        tconvert.write_safetensors(path, sd)
    loaded = tconvert.load_lpips(path, device="cpu")
    assert loaded.device.type == "cpu"
    frames = np.random.default_rng(5).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    assert abs(loaded.consecutive_mean_u8(frames) - jax_lp.consecutive_mean_u8(frames)) <= TOL


@pytest.mark.parametrize("kind", ["noise", "static"])
def test_mdvqs_with_lpips_matches_jax(models, kind):
    _, _, jax_lp, ours = models
    ref_scorer = jclip.CLIPScorer.build()
    port_scorer = tclip.CLIPScorer.build(device="cpu")
    load_jax_params(port_scorer, jax.tree.map(np.asarray, ref_scorer.params))
    rng_np = np.random.default_rng(3)
    frames = rng_np.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    if kind == "static":
        frames = np.repeat(frames[:1], 4, axis=0)
    want = jm.MDVQS(ref_scorer, lpips_metric=jax_lp).score(frames, "a test video")
    got = tm.MDVQS(port_scorer, lpips_metric=ours).score(frames, "a test video")
    assert got["perceptual_metric"] == want["perceptual_metric"] == "lpips-alex"
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert abs(got[k] - v) <= TOL, k
        elif k != "timings_s":
            assert got[k] == v, k
    if kind == "static":
        assert got["perceptual_distance"] < 1e-6 and got["score"] == 0.0
    # without the metric the port keeps the proxy
    assert tm.MDVQS(port_scorer).score(frames, "x")["perceptual_metric"] == \
        "random-projection-proxy"
