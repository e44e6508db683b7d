"""The port's StepEngine against the JAX package's, on zeroscope-tiny-hf with
the reference's (perturbed) weights bridged into the port.

Across implementations the validator runs its cross-platform regime
(same_platform=False, atol 5e-2, ``dvdx_tpu/network/validator.py``'s
``atol``): the two UNets agree to ~1e-6 in float32, but eps and z are bf16
leaves, so one side may round an element one bf16 ulp away (0.0078 at
|eps| <= 1, 0.0156 at |z| <= 4). A tampered leaf must be refused both ways,
with a tamper the tolerance cannot absorb (eps + 0.25). On one platform the
port's re-execution is bit for bit (the same-program gate: atol 1e-4, rtol
2^-7, and every leaf byte-equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvdx_tpu.verify import spotcheck as jspot
from dvdx_tpu_torch.pipelines.text2video import build_pipeline
from dvdx_tpu_torch.utils.bridge import load_pipeline_params
from dvdx_tpu_torch.verify import spotcheck as tspot

torch.set_num_threads(2)

PROMPT = "a red ball"
GEN = dict(seed=7, num_frames=4, height=32, width=32, num_steps=3, guidance_scale=7.5)
CROSS = dict(same_platform=False, atol=5e-2)
SAME = dict(same_platform=True, atol=1e-4, rtol=2.0 ** -7)


@pytest.fixture(scope="module")
def engines(tiny_hf_pipeline):
    tree = jax.tree.map(np.asarray, tiny_hf_pipeline.params)
    port = load_pipeline_params(build_pipeline("zeroscope-tiny-hf", device="cpu"), tree)
    return jspot.StepEngine(tiny_hf_pipeline), tspot.StepEngine(port)


@pytest.fixture(scope="module")
def records(engines):
    """(JAX record, port record): (video, zs, epss, ts) each."""
    jeng, teng = engines
    return jeng.generate_recorded(PROMPT, **GEN), teng.generate_recorded(PROMPT, **GEN)


def _to_jax(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor as the JAX package's ml_dtypes bfloat16 array (exact)."""
    return np.asarray(jnp.asarray(t.float().numpy(), jnp.bfloat16))


def _leaves(zs, epss, ts, tamper=None):
    leaves = {i: (int(ts[i]), zs[i], epss[i]) for i in range(len(ts))}
    if tamper is not None:
        t, z, e = leaves[tamper]
        leaves[tamper] = (t, z, e + 0.25 if isinstance(e, torch.Tensor)
                          else _to_jax(tspot.as_tensor(e) + 0.25))
    return leaves


def test_records_agree(records):
    """Both miners' records: the same schedule and base latent; over the 3
    steps the DDIM chain carries one-ulp differences forward, so the whole
    records agree within test_torch_pipeline's end-to-end bound (0.125), not
    the per-step tolerance the validator applies to a re-executed step."""
    (jv, jz, je, jt), (tv, tz, te, tt) = records
    assert tz.shape == jz.shape == (3, 4, 16, 16, 4) and tz.dtype == torch.bfloat16
    assert tv.shape == jv.shape == (4, 32, 32, 3) and tv.dtype == np.uint8
    np.testing.assert_array_equal(tt, jt)
    ok, err, bitwise = tspot.compare_arrays(tz[0], jz[0], bitwise=True, atol=0.0)
    assert ok and bitwise  # the base latent
    for got, want in ((tz, jz), (te, je)):
        ok, err, _ = tspot.compare_arrays(got, want, bitwise=False, atol=0.125)
        print(f"parity: max_abs_err {err:.3g}")  # shown by pytest -rP
        assert ok


@pytest.mark.parametrize("tamper", [None, 1])
def test_port_leaves_against_jax_validator(engines, records, tamper):
    jeng, _ = engines
    _, (_, zs, es, ts) = records
    zs, es = [_to_jax(a) for a in zs], [_to_jax(a) for a in es]
    results, _ = jspot.verify_revealed_steps(jeng, PROMPT, "", _leaves(zs, es, ts, tamper),
                                             [0, 1], 3, 7.5, **CROSS)
    assert results[0].passed
    assert results[1].passed == (tamper is None), results[1]


@pytest.mark.parametrize("tamper", [None, 1])
def test_jax_leaves_against_port_validator(engines, records, tamper):
    _, teng = engines
    (_, zs, es, ts), _ = records
    results, _ = tspot.verify_revealed_steps(teng, PROMPT, "", _leaves(zs, es, ts, tamper),
                                             [0, 1], 3, 7.5, **CROSS)
    assert results[0].passed
    assert results[1].passed == (tamper is None), results[1]


def test_port_reexecution_is_bitwise(engines, records):
    """Same platform: every revealed step re-executes to its bytes, the base
    latent re-derives from the seed, the video binds, and an eps leaf
    scaled by 1 + 2^-4 is refused."""
    _, teng = engines
    _, (video, zs, es, ts) = records
    assert teng.platform_tag == "torch-cpu"
    leaves = _leaves(zs, es, ts)
    results, z_next = tspot.verify_revealed_steps(teng, PROMPT, "", leaves, [0, 1, 2],
                                                  3, 7.5, **SAME)
    assert all(r.passed and r.bitwise for r in results.values()), results
    assert torch.equal(z_next[0].view(torch.int16), zs[1].view(torch.int16))
    base = teng.base_latent(GEN["seed"], 4, 32, 32)
    assert torch.equal(base.view(torch.int16), zs[0].view(torch.int16))
    frames = tspot.binding_frame_indices(b"secret", b"\x01" * 32, 4)
    ok, err = teng.verify_video_binding(video, leaves[2], 2, 3, 7.5, PROMPT,
                                        frame_indices=frames)
    assert ok, err
    t, z, e = leaves[1]
    leaves[1] = (t, z, (e.float() * (1 + 2.0 ** -4)).bfloat16())
    refused = tspot.verify_revealed_step(teng, PROMPT, "", leaves[1], 1, 3, 7.5,
                                         next_leaf=leaves[2], **SAME)
    assert not refused.passed and refused.reason == "eps re-execution mismatch"


@pytest.mark.parametrize("num_frames,k", [(16, 2), (4, 3), (24, 2), (1, 2)])
def test_binding_frame_indices_equal(num_frames, k):
    for secret in (b"", b"audit", bytes(range(32))):
        root = bytes(reversed(range(32)))
        assert tspot.binding_frame_indices(secret, root, num_frames, k) == \
            jspot.binding_frame_indices(secret, root, num_frames, k)


def test_compare_arrays_matches_reference():
    """Same verdicts and errors as the JAX package's compare_arrays, on torch
    tensors and on ml_dtypes arrays alike."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)).bfloat16()
    cases = [(a, a.clone()), (a, a + 2 ** -6), (a, a * 1.01), (a, a[:2])]
    for got, want in cases:
        for kw in (dict(bitwise=True, atol=1e-4, rtol=2.0 ** -7),
                   dict(bitwise=False, atol=5e-2)):
            ours = tspot.compare_arrays(got, _to_jax(want), **kw)
            theirs = jspot.compare_arrays(_to_jax(got), _to_jax(want), **kw)
            assert ours == theirs, (ours, theirs)
