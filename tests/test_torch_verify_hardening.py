"""The cases of ``tests/test_verify_hardening.py`` run against the port
(the JAX file stays): the port's ``verify/proof.sample_spotcheck_pairs``,
its ``InferenceProof``, ``StepEngine`` and network roles, on the port's
zeroscope-tiny (seed 0, zero leaves perturbed at seed 99: the JAX package's
weights) on the CPU:

* batched k-step re-execution is bitwise-identical to per-step launches;
* the per-response platform tag cannot downgrade bitwise verification;
* video-binding frames are post-commit-unpredictable;
* sample_spotcheck_pairs refuses grindable (secret-less) use;
* reward-settlement failures surface instead of being swallowed.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

from dvdx_tpu.verify.proof import InferenceProof as JInferenceProof
from dvdx_tpu.verify.proof import sample_spotcheck_pairs as jsample_spotcheck_pairs
from dvdx_tpu_torch.network.miner import Miner
from dvdx_tpu_torch.network.mock import build_mock_network as _build_mock_network
from dvdx_tpu_torch.network.validator import ValidatorConfig
from dvdx_tpu_torch.pipelines.text2video import build_pipeline
from dvdx_tpu_torch.utils.testing import perturb_zero_params
from dvdx_tpu_torch.verify.proof import InferenceProof, sample_spotcheck_pairs
from dvdx_tpu_torch.verify.spotcheck import StepEngine, binding_frame_indices


def _run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def build_mock_network(**kw):
    return _build_mock_network(device="cpu", **kw)


@pytest.fixture(scope="module")
def tiny_pipeline_module():
    return perturb_zero_params(build_pipeline("zeroscope-tiny", seed=0, device="cpu"), seed=99)


def test_multi_step_bitwise_matches_single(tiny_pipeline_module):
    """The one-launch batched verifier (multi_step_fn) must produce byte-equal
    results to the per-step program — the bitwise PoI chain depends on it."""
    engine = StepEngine(tiny_pipeline_module)
    prompt, neg = "a rotating cube", ""
    num_steps, gs = 3, 7.5
    _, zs, epss, _ = engine.generate_recorded(
        prompt, negative_prompt=neg, seed=11, num_frames=2, height=32,
        width=32, num_steps=num_steps, guidance_scale=gs)

    checks = [0, 1, 2]
    eps_b, znext_b = engine.reexecute_steps(prompt, neg, [zs[i] for i in checks],
                                            checks, num_steps, gs)
    for row, i in enumerate(checks):
        eps_s, znext_s = engine.reexecute_pair(prompt, neg, zs[i], i,
                                               num_steps, gs)
        assert torch.equal(eps_b[row].view(torch.int16), eps_s.view(torch.int16))
        assert torch.equal(znext_b[row].view(torch.int16), znext_s.view(torch.int16))
        # and both match the miner's recorded commitment
        assert torch.equal(eps_s.view(torch.int16), epss[i].view(torch.int16))


def test_sample_pairs_requires_secret():
    with pytest.raises(ValueError):
        sample_spotcheck_pairs(b"r" * 32, b"c" * 32, 25, b"")
    pairs = sample_spotcheck_pairs(b"r" * 32, b"c" * 32, 25, b"secret", 3)
    assert len(pairs) == 3
    for i, j in pairs:
        assert j == min(i + 1, 24)
    # different secrets -> different samples (unpredictability at commit time)
    seen = {tuple(sample_spotcheck_pairs(b"r" * 32, b"c" * 32, 25,
                                         bytes([s]) * 8, 3))
            for s in range(24)}
    assert len(seen) > 8


@pytest.mark.parametrize("steps,k", [(25, 3), (8, 8), (1, 1), (50, 5)])
def test_sample_pairs_equal_jax(steps, k):
    for s in range(6):
        secret = bytes([s]) * 8
        assert sample_spotcheck_pairs(b"r" * 32, b"c" * 32, steps, secret, k) == \
            jsample_spotcheck_pairs(b"r" * 32, b"c" * 32, steps, secret, k)


def test_inference_proof_dict_equals_jax():
    fields = dict(merkle_root=b"\x01" * 32, signature=b"\x02" * 64, miner_pubkey=b"\x03" * 32,
                  challenge=b"\x04" * 32, seed=2 ** 63 + 5, num_steps=3,
                  timesteps=[961, np.int64(481), 1], video_sha256=b"\x05" * 32)
    d = InferenceProof(**fields).to_dict()
    assert json.dumps(d, sort_keys=True) == json.dumps(JInferenceProof(**fields).to_dict(),
                                                       sort_keys=True)
    assert InferenceProof.from_dict(json.loads(json.dumps(d))) == InferenceProof(
        **dict(fields, timesteps=[961, 481, 1]))


def test_binding_frames_secret_derived():
    root = b"\x09" * 32
    a = binding_frame_indices(b"s1", root, 16, k=2)
    assert len(a) == 2 and all(0 <= i < 16 for i in a) and a == sorted(set(a))
    # varies with the secret -> miner cannot pre-pick which frames to forge
    seen = {tuple(binding_frame_indices(bytes([s]) * 8, root, 16, k=2))
            for s in range(32)}
    assert len(seen) > 10
    # never asks for more frames than exist
    assert binding_frame_indices(b"s", root, 1, k=2) == [0]


class PlatformLiarMiner(Miner):
    """Honest compute, but claims a different backend in the response —
    attempting to downgrade the validator to tolerance-mode verification
    (ADVICE r1 medium finding)."""

    def _generate_with_proof(self, req):
        resp = super()._generate_with_proof(req)
        resp.platform = "cuda-totally-not-this-machine"
        return resp


def test_platform_claim_cannot_downgrade_bitwise(tiny_pipeline_module):
    cfg = ValidatorConfig(sample_size=2, num_checkpoints=2, num_frames=2,
                          width=32, height=32, num_steps=3)
    net = build_mock_network(n_miners=2, pipeline=tiny_pipeline_module,
                             validator_config=cfg)
    # miner 0 lies about its platform; its registry pin says otherwise
    liar = PlatformLiarMiner(tiny_pipeline_module, net.miners[0].keypair,
                             net.registry)
    net.transport.serve("mock://miner-0", liar.handle)

    report = _run(net.run_request("req-platform", "a shiny teapot"))
    lied = report["miners"]["0"]
    honest = report["miners"]["1"]
    # contradiction with the registration pin is flagged, not relaxed
    assert lied["failed_check"] == "platform"
    assert lied["score"] == 0.0
    # honest miner still verified bitwise
    assert honest.get("reexec_bitwise") is True


def test_require_platform_refuses_foreign_pin(tiny_pipeline_module):
    """Homogeneous-deployment policy: a miner that honestly self-pinned a
    DIFFERENT backend (selecting tolerance-mode verification) is scored 0
    under require_platform instead of being verified with atol slack."""
    here = "torch-cpu"
    cfg = ValidatorConfig(sample_size=2, num_checkpoints=1, num_frames=2,
                          width=32, height=32, num_steps=2,
                          require_platform=here)
    net = build_mock_network(n_miners=2, pipeline=tiny_pipeline_module,
                             validator_config=cfg)
    # miner 0 re-pins itself to a foreign backend (its own signed choice)
    # and consistently claims it in responses (no pin contradiction)
    net.registry.neurons[0].platform = "gpu"

    class ConsistentForeign(type(net.miners[0])):
        def _generate_with_proof(self, req):
            resp = super()._generate_with_proof(req)
            resp.platform = "gpu"
            return resp

    foreign_miner = ConsistentForeign(tiny_pipeline_module,
                                      net.miners[0].keypair, net.registry)
    net.transport.serve("mock://miner-0", foreign_miner.handle)

    report = _run(net.run_request("req-reqplat", "a copper kettle"))
    foreign = report["miners"]["0"]
    native = report["miners"]["1"]
    assert foreign["failed_check"] == "platform_policy"
    assert foreign["score"] == 0.0
    assert not foreign.get("cheat", False)  # policy refusal, not fraud
    assert native.get("reexec_bitwise") is True


def test_oversized_geometry_rejected_by_miner(tiny_pipeline_module):
    """Height/width are memory-dominant and must be bounded like
    frames/steps: an oversized request degrades gracefully to an error
    response instead of OOMing the chip."""
    from dvdx_tpu_torch.network import protocol as P
    from dvdx_tpu_torch.network.base import Registry
    from dvdx_tpu_torch.network.miner import MinerConfig
    from dvdx_tpu_torch.verify.proof import Keypair

    reg = Registry()
    vkp = Keypair.from_seed(b"geom-validator")
    reg.register(vkp.public_bytes, "v", role="validator", stake=100)
    miner = Miner(tiny_pipeline_module, Keypair.from_seed(b"geom-miner"),
                  reg, MinerConfig(max_height=64, max_width=64))
    import time as _time

    req = P.InferenceRequest(request_id="g1", prompt="huge", width=4096,
                             height=4096, num_frames=2, num_steps=2, seed=1,
                             challenge=b"\x03" * 32, issued_at=_time.time(),
                             validator_pubkey=vkp.public_bytes)
    req.signature = vkp.sign(P.signing_bytes(req))
    resp = miner.handle(req)
    assert resp.status == "error" and "limits" in resp.error


def test_unpinned_miner_defaults_to_bitwise(tiny_pipeline_module):
    """A miner with no pinned platform gets the secure default: its claimed
    tag is ignored and re-execution is demanded bitwise."""
    cfg = ValidatorConfig(sample_size=1, num_checkpoints=2, num_frames=2,
                          width=32, height=32, num_steps=3)
    net = build_mock_network(n_miners=1, pipeline=tiny_pipeline_module,
                             validator_config=cfg)
    info = net.registry.get(0)
    info.platform = ""          # simulate legacy/unpinned registration
    liar = PlatformLiarMiner(tiny_pipeline_module, net.miners[0].keypair,
                             net.registry)
    net.transport.serve("mock://miner-0", liar.handle)
    report = _run(net.run_request("req-unpinned", "a wooden bridge"))
    d = report["miners"]["0"]
    # no pin -> no platform fail, but the claim did NOT buy tolerance mode:
    # verification ran (and passed) bitwise because compute was honest
    assert d["checks"]["reexecution"] is True
    assert d["same_platform"] is True
    assert d.get("reexec_bitwise") is True


def test_distribute_rewards_failure_surfaces(tiny_pipeline_module):
    """Settlement errors must land in the round report + metrics, not pass
    silently (ADVICE r1)."""
    cfg = ValidatorConfig(sample_size=1, num_checkpoints=1, num_frames=2,
                          width=32, height=32, num_steps=2)
    net = build_mock_network(n_miners=1, pipeline=tiny_pipeline_module,
                             validator_config=cfg)
    # no deposit was made for this request id -> ledger settlement must fail
    report = _run(net.validator.run_round("req-no-deposit", "a glass orb"))
    assert "ledger_error" in report
    assert net.validator.metrics["ledger_errors"] >= 1


def test_cfg_split_round_is_bitwise(tiny_pipeline_module):
    """cfg_split (sequential CFG, the XL single-chip program) is part of the
    step-program identity: the request pins it, the miner generates with it,
    and the validator re-executes with it — still bitwise."""
    cfg = ValidatorConfig(sample_size=1, num_checkpoints=2, num_frames=2,
                          width=32, height=32, num_steps=3, cfg_split=True)
    net = build_mock_network(n_miners=1, pipeline=tiny_pipeline_module,
                             validator_config=cfg)
    report = _run(net.run_request("req-cfgsplit", "a bronze statue"))
    d = report["miners"]["0"]
    assert d["checks"]["reexecution"] is True
    assert d.get("reexec_bitwise") is True
    assert d["checks"].get("video_binding") is True
    assert d["score"] > 0


def test_spotcheck_budget_is_exactly_k(tiny_pipeline_module):
    """T-1 counts toward the k re-execution budget (k total, not k+1) and
    index 0 is revealed compare-only — the <10% overhead accounting."""
    cfg = ValidatorConfig(sample_size=1, num_checkpoints=3, num_frames=2,
                          width=32, height=32, num_steps=8)
    net = build_mock_network(n_miners=1, pipeline=tiny_pipeline_module,
                             validator_config=cfg)
    report = _run(net.run_request("req-budget", "a copper kettle"))
    d = report["miners"]["0"]
    checks = d["spotcheck_indices"]
    assert len(checks) == 3                      # == num_checkpoints
    assert (cfg.num_steps - 1) in checks         # T-1 folded into the budget
    assert net.validator.metrics["reexec_steps"] == 3
