"""Port vs reference, end to end: ``generate(record=True)`` on
zeroscope-tiny-hf with the reference's (perturbed) weights bridged into the
port, the Merkle leaves and root over the recorded steps, and the flat-npz
parameter cache read without ml_dtypes.

Tolerances of the end-to-end run: z_0 is bit-equal (same seed, same noise).
The UNet runs in float32 and agrees with the reference to ~1e-6, but its
output is rounded to the bf16 latent dtype, so a 1e-6 difference can flip
one bf16 rounding of eps (2^-8 relative), which the DDIM chain carries into
later steps: over 3 steps z and eps agree to 0.125 absolute (measured 0.0625
at |z| <= 4) and >= 80% of the latents stay bit-equal; frames, decoded in
float32 and truncated to uint8, differ by at most 2 levels.
"""

import jax
import numpy as np
import pytest
import torch

from dvdx_tpu.pipelines.text2video import _save_flat_npz
from dvdx_tpu.pipelines.text2video import generate as jgenerate
from dvdx_tpu.verify import merkle as jmerkle
from dvdx_tpu_torch.pipelines.text2video import build_pipeline, encode_prompts, generate
from dvdx_tpu_torch.utils.bridge import load_flat_npz, load_pipeline_params
from dvdx_tpu_torch.utils.testing import perturb_zero_params
from dvdx_tpu_torch.verify import merkle as tmerkle

torch.set_num_threads(2)

GEN = dict(seed=7, num_frames=4, height=32, width=32, num_steps=3, record=True)


@pytest.fixture(scope="module")
def bridged(tiny_hf_pipeline):
    tree = jax.tree.map(np.asarray, tiny_hf_pipeline.params)
    port = build_pipeline("zeroscope-tiny-hf", device="cpu")
    return tiny_hf_pipeline, load_pipeline_params(port, tree)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("cfg_split", [False, True])
def test_generate_record_matches_reference(bridged, cfg_split):
    ref, port = bridged
    vj, (zj, ej, tj) = jgenerate(ref, "a red ball", cfg_split=cfg_split, **GEN)
    vt, (zt, et, tt) = generate(port, "a red ball", cfg_split=cfg_split, **GEN)
    np.testing.assert_array_equal(tt, tj)
    assert zt.shape == zj.shape == (3, 1, 4, 16, 16, 4) and zt.dtype == torch.bfloat16
    assert vt.shape == vj.shape == (4, 32, 32, 3) and vt.dtype == np.uint8
    np.testing.assert_array_equal(_f32(zt[0]), _f32(zj[0]))  # the base latent
    print(f"parity: max_abs_err z {np.abs(_f32(zt) - _f32(zj)).max():.3g}, eps "
          f"{np.abs(_f32(et) - _f32(ej)).max():.3g} (max_abs_ref "
          f"{np.abs(_f32(ej)).max():.3g}); z bit-equal share "
          f"{(_f32(zt) == _f32(zj)).mean():.3f}; frames max level diff "
          f"{np.abs(vt.astype(int) - vj.astype(int)).max()}")  # shown by pytest -rP
    np.testing.assert_allclose(_f32(zt), _f32(zj), atol=0.125, rtol=0)
    np.testing.assert_allclose(_f32(et), _f32(ej), atol=0.125, rtol=0)
    assert (_f32(zt) == _f32(zj)).mean() >= 0.8
    assert np.abs(vt.astype(int) - vj.astype(int)).max() <= 2
    assert vt.std() > 0


def test_generate_is_deterministic(bridged):
    _, port = bridged
    v1, (z1, e1, _) = generate(port, "a lighthouse", negative_prompt="blurry", **GEN)
    v2, (z2, e2, _) = generate(port, "a lighthouse", negative_prompt="blurry", **GEN)
    assert torch.equal(z1, z2) and torch.equal(e1, e2) and np.array_equal(v1, v2)


def test_encode_prompts_shape(bridged):
    _, port = bridged
    hidden = encode_prompts(port, ["", "a red ball"])
    assert hidden.shape == (2, 16, 64) and torch.isfinite(hidden).all()


def test_merkle_leaves_and_root_match_reference():
    """The same bf16 arrays: the reference hashes ml_dtypes numpy arrays, the
    port torch bf16 tensors; leaf bytes, leaf hashes, root and proofs agree."""
    rng = np.random.default_rng(3)
    zs32 = rng.normal(size=(5, 1, 2, 3, 4, 4)).astype(np.float32)
    es32 = rng.normal(size=zs32.shape).astype(np.float32)
    ts = np.array([801, 601, 401, 201, 1], np.int32)
    zs_t, es_t = torch.from_numpy(zs32).bfloat16(), torch.from_numpy(es32).bfloat16()
    zs_j = jax.numpy.asarray(zs32, jax.numpy.bfloat16)
    es_j = jax.numpy.asarray(es32, jax.numpy.bfloat16)
    zs_n, es_n = np.asarray(zs_j), np.asarray(es_j)
    for i in range(5):
        assert tmerkle.leaf_bytes(ts[i], zs_t[i], es_t[i]) == jmerkle.leaf_bytes(
            ts[i], zs_n[i], es_n[i])
    want = jmerkle.MerkleCommitment(ts, zs_n, es_n, use_native=False)
    got = tmerkle.MerkleCommitment(ts, zs_t, es_t)
    assert got.leaves == want.leaves and got.root == want.root
    t, zb, eb, path = got.open(3)
    assert (t, zb, eb) == want.open(3)[:3]
    assert tmerkle.verify_merkle_proof(got.leaves[3], path, want.root)
    assert jmerkle.verify_merkle_proof(got.leaves[3], path, got.root)


def test_flat_npz_round_trip(tmp_path, tiny_hf_pipeline):
    """The reference writes its parameter cache (float32 and bfloat16
    leaves); the port reads it without ml_dtypes, bit for bit, and the
    bridged modules run."""
    tree = jax.tree.map(np.asarray, tiny_hf_pipeline.params)
    tree["vae_dec"] = jax.tree.map(lambda a: a.astype(jax.numpy.bfloat16), tree["vae_dec"])
    path = str(tmp_path / "params.npz")
    _save_flat_npz(path, tree)
    got = load_flat_npz(path)
    want_leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(want_leaves) == len(jax.tree_util.tree_leaves(got))
    for keys, want in want_leaves:
        node = got
        for k in keys:
            node = node[k.key]
        assert node.shape == want.shape
        if want.dtype.name == "bfloat16":
            assert node.dtype == torch.bfloat16
            np.testing.assert_array_equal(node.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(node.numpy(), want)
    port = build_pipeline("zeroscope-tiny-hf", device="cpu")
    load_pipeline_params(port, got)
    assert port.vae_decoder.conv_in.weight.dtype == torch.float32


def test_perturb_zero_params_fills_only_zero_leaves():
    port = build_pipeline("zeroscope-tiny-hf", seed=3, device="cpu")
    before = {n: p.clone() for n, p in port.named_parameters()}
    perturb_zero_params(port, seed=99)
    for name, p in port.named_parameters():
        if before[name].any():
            assert torch.equal(p, before[name]), name
        else:
            assert p.any() and p.abs().max() < 0.2, name
    assert port.unet.conv_out_zero.weight.any()
