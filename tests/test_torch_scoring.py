"""The port's scoring against the JAX package's, on numpy-seeded videos.

* Authenticity: the statistics are exact. The device path's integer
  reductions (per-frame histograms, per-pair |diff| sums) equal numpy's
  counts, and the finished dicts equal the reference's, bit for bit, on the
  device and host paths of both packages.
* The perceptual proxy: within 1e-5 of the reference (its conv weights are
  the reference's threefry normals, within 3 float32 ulps; SAME padding at
  stride 2 pads 0 before and 1 after on an even size).
* CLIP prompt fidelity with the reference scorer's parameters bridged in:
  per-frame cosines and the score within 1e-5, at the tower's own 32x32 and
  at geometries it downscales (48x80) and upscales (20x24) from, through
  ``jax.image.resize``'s antialiased resampling.
* MD-VQS: the same keys, each value within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvdx_tpu.scoring import clip_score as jclip
from dvdx_tpu.scoring import mdvqs as jm
from dvdx_tpu_torch.ops import rng
from dvdx_tpu_torch.scoring import clip_score as tclip
from dvdx_tpu_torch.scoring import mdvqs as tm
from dvdx_tpu_torch.utils.bridge import load_jax_params

TOL = 1e-5


def _video(kind: str, seed: int = 0) -> np.ndarray:
    rng_np = np.random.default_rng(seed)
    if kind == "noise":
        return rng_np.integers(0, 256, (4, 24, 40, 3), dtype=np.uint8)
    if kind == "static":
        return np.repeat(rng_np.integers(0, 256, (1, 24, 40, 3), dtype=np.uint8), 4, axis=0)
    if kind == "abab":
        ab = rng_np.integers(0, 256, (2, 24, 40, 3), dtype=np.uint8)
        return np.concatenate([ab, ab])
    if kind == "two_frames":
        return rng_np.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    if kind == "one_frame":
        return rng_np.integers(0, 256, (1, 16, 16, 3), dtype=np.uint8)
    if kind == "gradient":  # a moving low-contrast ramp
        x = np.arange(40)[None, None, :, None] + 3 * np.arange(5)[:, None, None, None]
        return np.broadcast_to((x % 64 + 96).astype(np.uint8), (5, 24, 40, 3)).copy()
    raise ValueError(kind)


KINDS = ["noise", "static", "abab", "two_frames", "one_frame", "gradient"]


@pytest.mark.parametrize("kind", KINDS)
def test_authenticity_statistics_exact(kind):
    frames = _video(kind)
    ref = jm.verify_video_authenticity(frames)
    assert jm.verify_video_authenticity(jnp.asarray(frames)) == ref
    assert tm.verify_video_authenticity(frames) == ref
    assert tm.verify_video_authenticity(torch.from_numpy(frames)) == ref
    assert tm.verify_video_authenticity(torch.from_numpy(frames), host_frames=frames) == ref


@pytest.mark.parametrize("kind", ["noise", "abab", "two_frames", "gradient"])
def test_device_reductions_equal_numpy(kind):
    frames = _video(kind)
    counts, diff_sums = tm.auth_stats_device(torch.from_numpy(frames))
    gray = frames.astype(np.int64).sum(-1) // 3
    want = np.stack([np.bincount(g.reshape(-1), minlength=256) for g in gray])
    np.testing.assert_array_equal(counts, want)
    x = frames.astype(np.int64)
    np.testing.assert_array_equal(diff_sums, np.abs(x[1:] - x[:-1]).sum(axis=(1, 2, 3)))


def test_percep_weights_are_the_reference_draws():
    key = jax.random.key(12345)
    assert rng.key(12345).tolist() == np.asarray(jax.random.key_data(key)).tolist()
    for s, w in enumerate(tm.percep_weights("cpu")):
        folded = jax.random.fold_in(key, s)
        assert rng.fold_in(rng.key(12345), s).tolist() == \
            np.asarray(jax.random.key_data(folded)).tolist()
        c = 3 if s == 0 else 32
        want = np.asarray(jax.random.normal(folded, (3, 3, c, 32)))
        got = rng.normal(rng.fold_in(rng.key(12345), s), (3, 3, c, 32), device="cpu")
        ulps = np.abs(got.numpy().view(np.int32).astype(np.int64) - want.view(np.int32))
        assert ulps.max() <= 3
        assert torch.equal(w, (got * 0.2).permute(3, 2, 0, 1))  # HWIO -> OIHW


@pytest.mark.parametrize("shape", [(4, 32, 32), (3, 33, 47), (5, 48, 80), (2, 8, 9)])
def test_perceptual_distance_matches(shape):
    frames = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3), dtype=np.uint8)
    want = float(jm._perceptual_distance_pairs_u8(jnp.asarray(frames)))
    got = float(tm.perceptual_distance_pairs(torch.from_numpy(frames).float() / 127.5 - 1.0))
    print(f"perceptual: {got:.7f} vs {want:.7f}")  # shown by pytest -rP
    assert abs(got - want) <= TOL


@pytest.mark.parametrize("hw", [(48, 80), (32, 32), (20, 24), (64, 40)])
def test_resize_matches_jax_image_resize(hw):
    x = np.random.default_rng(hw[0]).normal(size=(2, *hw, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 32, 32, 3), "bilinear"))
    got = tclip.resize_bilinear(torch.from_numpy(x), 32).numpy()
    assert np.abs(got - want).max() <= TOL


@pytest.fixture(scope="module")
def scorers():
    ref = jclip.CLIPScorer.build()
    port = tclip.CLIPScorer.build(device="cpu")
    load_jax_params(port, jax.tree.map(np.asarray, ref.params))
    return ref, port


def test_scorer_build_draws_text_proj_as_the_reference():
    ref = jclip.CLIPScorer.build(seed=7)
    port = tclip.CLIPScorer.build(seed=7, device="cpu")
    np.testing.assert_array_equal(port.text_proj.detach().numpy(),
                                  np.asarray(ref.params["text_proj"]))
    again = tclip.CLIPScorer.build(seed=7, device="cpu")
    for a, b in zip(port.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hw", [(32, 32), (48, 80), (20, 24)])
@pytest.mark.parametrize("prompt", ["a red ball", "a lighthouse at dusk, waves crashing"])
def test_clip_score_matches(scorers, hw, prompt):
    ref, port = scorers
    frames = np.random.default_rng(hw[1]).integers(0, 256, (3, *hw, 3), dtype=np.uint8)
    want = ref.frame_scores(frames, prompt)
    got = port.frame_scores(frames, prompt)
    assert np.abs(got - want).max() <= TOL
    assert abs(port.score_video(frames, prompt) - ref.score_video(frames, prompt)) <= TOL


@pytest.mark.parametrize("kind", ["noise", "gradient", "static"])
def test_mdvqs_matches(scorers, kind):
    ref_scorer, port_scorer = scorers
    frames = _video(kind, seed=3)
    want = jm.MDVQS(ref_scorer).score(frames, "a blue cube spinning")
    got = tm.MDVQS(port_scorer).score(frames, "a blue cube spinning",
                                      frames_dev=torch.from_numpy(frames))
    assert set(got) == set(want)
    assert set(got["timings_s"]) == set(want["timings_s"]) - {"device_put"}
    for k, v in want.items():
        if isinstance(v, float):
            assert abs(got[k] - v) <= TOL, k
        elif k != "timings_s":
            assert got[k] == v, k
    if kind == "static":
        assert got["score"] == want["score"] == 0.0


@pytest.mark.parametrize("has_cv2", [True, False])
def test_flow_magnitude_both_branches(monkeypatch, has_cv2):
    """cv2's Farneback where cv2 imports, the gradient proxy where it does
    not; equal to the reference's either way, with the stride-slice above
    320 pixels of width."""
    monkeypatch.setattr(jm, "_HAS_CV2", has_cv2)
    monkeypatch.setattr(tm, "_HAS_CV2", has_cv2)
    for frames in (_video("gradient"), np.random.default_rng(1).integers(
            0, 256, (3, 40, 700, 3), dtype=np.uint8)):
        assert tm.mean_flow_magnitude(frames) == jm.mean_flow_magnitude(frames)
