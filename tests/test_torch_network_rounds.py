"""Validator rounds of the port's mock network on the CPU, and rounds across
the two implementations.

Torch only: miners and validator of the port over zeroscope-tiny (the
rotary temporal style) holding the reference's perturbed weights. The
honest miner re-executes bit for bit (same-program regime: atol 1e-4, rtol
2^-7); the adversaries fail at the check names of ``tests/test_network.py``
(lazy at ``reexecution``, wrong seed at ``base_noise``, wrong video at
``video_binding``), and so does the mantissa-truncating ``approx`` miner;
the miner's reveal and replay refusals are the reference's.

Across implementations (the same weights on both sides, every message
crossing as wire bytes from one package's encoding to the other's): a torch
miner is verified by the JAX validator and a JAX miner by the torch
validator, both in the cross-platform regime (``same_platform`` False, atol
5e-2, the reference's ``ValidatorConfig.atol``), and a lazy miner is caught
both ways. The two validators' reports carry the same keys. The same holds
for both packages loading one diffusers checkpoint (float32) with its CLIP
BPE tokenizer.

An honest miner across implementations may also be refused in exactly one
way, ROADMAP §3.1 (open on purpose: the bound is the reference's own): the
leaves are bf16 even for a float32 model, so the two programs' z_{t+1} can
round to neighbouring bf16 values, and at |z| in [8, 16) one ulp (0.0625)
exceeds atol 5e-2. The seed comes from the validator's random challenge,
so about 1 round in 10 meets it. ``honest_or_known_refusal`` accepts that
refusal, and only that one, and prints it (``pytest -rP``): it runs the
validator's re-execution again on the miner's committed leaves and requires
every element beyond the bound to lie one ulp apart at |z| >= 8 on both
sides.

Rounds that do not test liveness ping with a 30 s timeout, so CPU load under
parallel test workers cannot drop a miner; the liveness tests use a miner
that is absent or whose transport fails at once, never a slow one.
"""

import asyncio
import time
from typing import NamedTuple

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from dvdx_tpu.network import protocol as JP
from dvdx_tpu.network.base import Registry as JRegistry
from dvdx_tpu.network.ledger import Ledger as JLedger
from dvdx_tpu.network.miner import Miner as JMiner
from dvdx_tpu.network.mock import LazyMiner as JLazyMiner
from dvdx_tpu.network.transport import MockTransport as JMockTransport
from dvdx_tpu.network.validator import Validator as JValidator
from dvdx_tpu.network.validator import ValidatorConfig as JValidatorConfig
from dvdx_tpu.verify.proof import Keypair as JKeypair
from dvdx_tpu.verify.spotcheck import verify_revealed_steps as jverify_revealed_steps
from dvdx_tpu_torch.network import protocol as P
from dvdx_tpu_torch.network.base import Registry
from dvdx_tpu_torch.network.ledger import Ledger
from dvdx_tpu_torch.network.miner import Miner, MinerConfig
from dvdx_tpu_torch.network.mock import LazyMiner, build_mock_network
from dvdx_tpu_torch.network.transport import MockTransport
from dvdx_tpu_torch.network.validator import Validator, ValidatorConfig
from dvdx_tpu_torch.pipelines.text2video import build_pipeline
from dvdx_tpu_torch.utils.bridge import load_pipeline_params
from dvdx_tpu_torch.verify.merkle import leaf_hash, verify_merkle_proof
from dvdx_tpu_torch.verify.proof import Keypair
from dvdx_tpu_torch.verify.spotcheck import verify_revealed_steps
from tests.test_torch_generate_path import ckpt_pipes, fake_ckpt  # noqa: F401  (fixtures)

torch.set_num_threads(2)

GEOMETRY = dict(num_frames=2, width=32, height=32, num_steps=3)
STAKE = 10_000


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _cfg(tmp, **kw):
    base = dict(sample_size=kw.pop("sample_size", 2), num_checkpoints=3, ping_timeout_s=30,
                results_dir=str(tmp), **GEOMETRY)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def tiny_port(tiny_pipeline):
    """The port's zeroscope-tiny holding the reference's perturbed weights."""
    tree = jax.tree.map(np.asarray, tiny_pipeline.params)
    return load_pipeline_params(build_pipeline("zeroscope-tiny", device="cpu"), tree)


class StrategyPinnedMiner(Miner):
    """An honest miner pinning a strategy no validator knows (the
    validator's strategies are ``parallel.strategies.PRESETS``)."""

    @property
    def platform_tag(self) -> str:
        return "torch-cpu:warp"


def _add_miner(net, miner, i):
    addr = f"mock://extra-{i}"
    uid = miner.register(addr, stake=STAKE, platform=miner.platform_tag)
    net.ledger.mint(f"miner-{uid}", STAKE)
    net.ledger.stake(f"miner-{uid}", STAKE)
    net.transport.serve(addr, miner.handle)
    net.miners.append(miner)
    return uid


ROLES = ["honest", "lazy", "wrong_seed", "wrong_video", "approx", "strategy_pin"]


@pytest.fixture(scope="module")
def mixed_round(tiny_port, tmp_path_factory):
    """One round over an honest miner, the four adversaries and a
    strategy-pinned miner -> (net, report, {role: uid})."""
    tmp = tmp_path_factory.mktemp("round")
    net = build_mock_network(n_miners=5, adversaries=ROLES[:5], pipeline=tiny_port,
                             validator_config=ValidatorConfig(**_cfg(tmp, sample_size=6)))
    pinned = _add_miner(net, StrategyPinnedMiner(tiny_port, Keypair.from_seed(b"pinned"),
                                                 net.registry), 5)
    report = _run(net.run_request("req-1", "a blue cube spinning"))
    uids = {role: str(uid) for uid, role in enumerate(ROLES[:5])}
    return net, report, {**uids, "strategy_pin": str(pinned)}


def test_honest_round_is_bitwise(mixed_round):
    net, report, uid = mixed_round
    assert set(report["miners"]) == set(uid.values())
    d = report["miners"][uid["honest"]]
    assert not d.get("cheat") and "failed_check" not in d, d
    for check in ("echo", "identity", "timesteps", "signature", "authenticity", "merkle",
                  "base_noise", "reexecution", "video_binding"):
        assert d["checks"][check] is True, check
    assert d["same_platform"] is True and d["regime_atol"] == 1e-4
    assert d["reexec_bitwise"] is True and d["reexec_max_err"] == 0.0
    assert d["score"] > 0.0
    assert net.ledger.requests["req-1"].status == "distributed"
    assert net.ledger.stake_of(f"miner-{uid['honest']}") == STAKE
    for key in ("video_decode", "authenticity", "reveal_roundtrip", "merkle_verify",
                "base_noise", "reexecution", "video_binding", "mdvqs_score"):
        assert key in d["timings_s"], key
    assert "timings_s" in d["mdvqs"]
    for key in ("generate", "gen_compute_wall", "gen_leaf_fetch", "gen_video_fetch",
                "merkle_commit", "encode_mp4"):
        assert key in d["miner_timings_s"], key


@pytest.mark.parametrize("role,check,cheat", [
    ("lazy", "reexecution", True),
    ("wrong_seed", "base_noise", True),
    ("wrong_video", "video_binding", True),
    ("approx", "reexecution", True),
    ("strategy_pin", "platform_pin", False),
])
def test_adversary_fails_at_the_reference_check(mixed_round, role, check, cheat):
    net, report, uid = mixed_round
    d = report["miners"][uid[role]]
    assert d["failed_check"] == check, d
    assert d.get("cheat", False) is cheat
    assert d["score"] == 0.0
    want = STAKE - int(STAKE * net.validator.config.slash_fraction) if cheat else STAKE
    assert net.ledger.stake_of(f"miner-{uid[role]}") == want


def test_round_emits_weights_on_ledger(mixed_round):
    net, report, _ = mixed_round
    assert report.get("weights_epoch") == net.ledger.weights_epoch >= 1
    assert net.ledger.weights == net.validator.scores.weights_u16()


def test_dead_miner_filtered_by_ping(tiny_port, tmp_path):
    net = build_mock_network(n_miners=2, pipeline=tiny_port,
                             validator_config=ValidatorConfig(**_cfg(tmp_path)))
    net.transport.remove("mock://miner-0")  # absent: pings fail at once
    report = _run(net.run_request("req-dead", "a lighthouse"))
    assert set(report["miners"]) == {"1"}
    assert report["miners"]["1"]["checks"]["reexecution"]
    assert net.validator.metrics.get("ping_failures", 0) >= 1


class _RevealBlackhole:
    """Drops every RevealRequest; with ping_dies, also every ping after the
    first reveal attempt (a miner that crashed mid-round)."""

    def __init__(self, inner, ping_dies: bool):
        self.inner, self.ping_dies, self.saw_reveal = inner, ping_dies, False

    async def request(self, address, msg, timeout_s=300.0):
        if isinstance(msg, P.RevealRequest):
            self.saw_reveal = True
            raise asyncio.TimeoutError("blackholed reveal")
        if isinstance(msg, P.Ping) and self.saw_reveal and self.ping_dies:
            raise asyncio.TimeoutError("miner crashed")
        return await self.inner.request(address, msg, timeout_s=timeout_s)


@pytest.mark.parametrize("ping_dies,expect_cheat,expect_check", [
    (True, False, "reveal_unreachable"),
    (False, True, "reveal_refused"),
])
def test_reveal_abort_slash_requires_reachability(tiny_port, tmp_path, ping_dies,
                                                  expect_cheat, expect_check):
    net = build_mock_network(n_miners=1, pipeline=tiny_port,
                             validator_config=ValidatorConfig(**_cfg(tmp_path, sample_size=1)))
    net.validator.transport = _RevealBlackhole(net.transport, ping_dies)
    report = _run(net.run_request("req-abort", "a glass of water"))
    d = report["miners"]["0"]
    assert d["failed_check"] == expect_check, d
    assert d.get("cheat", False) is expect_cheat
    assert d["score"] == 0.0
    assert (net.ledger.stake_of("miner-0") < STAKE) is expect_cheat


@pytest.fixture(scope="module")
def lone_miner(tiny_port, tmp_path_factory):
    reg = Registry()
    vkp = Keypair.from_seed(b"spool-validator")
    reg.register(vkp.public_bytes, "v", role="validator", stake=100)
    cfg = MinerConfig(max_stored_proofs=1,
                      spool_dir=str(tmp_path_factory.mktemp("spool")))
    return Miner(tiny_port, Keypair.from_seed(b"spool-miner"), reg, cfg), vkp


def _signed(vkp, msg, issued_at=None):
    msg.issued_at = time.time() if issued_at is None else issued_at
    msg.signature = vkp.sign(P.signing_bytes(msg))
    return msg


def _request(vkp, rid, seed):
    return P.InferenceRequest(request_id=rid, prompt="spool", width=32, height=32,
                              num_frames=2, num_steps=2, seed=seed, challenge=b"\x01" * 32,
                              validator_pubkey=vkp.public_bytes)


def test_miner_spool_survives_lru_eviction(lone_miner):
    """Reveals work after the in-memory LRU evicts a trace (disk spool);
    unsigned requests and index floods are refused; revealed bytes verify
    against the original root."""
    miner, vkp = lone_miner
    r1 = miner.handle(_signed(vkp, _request(vkp, "sp-1", 1)))
    r2 = miner.handle(_signed(vkp, _request(vkp, "sp-2", 2)))  # evicts sp-1
    assert r1.status == "ok" and r2.status == "ok"
    assert r1.latent_dtype == "bfloat16" and r1.latent_shape == [2, 16, 16, 4]
    assert r1.platform == "torch-cpu"
    unsigned = miner.handle(_request(vkp, "sp-x", 3))
    assert unsigned.status == "error" and "signature" in unsigned.error
    reveal = miner.handle(_signed(vkp, P.RevealRequest(
        request_id="sp-1", merkle_root=r1.merkle_root, leaf_indices=[0, 1],
        validator_pubkey=vkp.public_bytes)))
    assert reveal.status == "ok", reveal.error
    flood = miner.handle(_signed(vkp, P.RevealRequest(
        request_id="sp-1", merkle_root=r1.merkle_root, leaf_indices=list(range(1000)),
        validator_pubkey=vkp.public_bytes)))
    assert flood.status == "error" and "too many" in flood.error
    wrong_root = miner.handle(_signed(vkp, P.RevealRequest(
        request_id="sp-1", merkle_root=b"\x00" * 32, leaf_indices=[0],
        validator_pubkey=vkp.public_bytes)))
    assert wrong_root.status == "error" and "root mismatch" in wrong_root.error
    for idx, t, zb, eb, path in reveal.leaves:
        z = torch.from_numpy(np.frombuffer(zb, np.int16).copy()).view(torch.bfloat16)
        e = torch.from_numpy(np.frombuffer(eb, np.int16).copy()).view(torch.bfloat16)
        assert verify_merkle_proof(leaf_hash(int(t), z, e),
                                   [(bytes(h), bool(r)) for h, r in path], r1.merkle_root)


def test_replayed_and_stale_requests_rejected(lone_miner):
    miner, vkp = lone_miner
    stale = miner.handle(_signed(vkp, _request(vkp, "rp-old", 5), time.time() - 10_000))
    assert stale.status == "error" and "stale" in stale.error
    forged = _signed(vkp, _request(vkp, "rp-forge", 5), time.time() - 10_000)
    forged.issued_at = time.time()  # issued_at is covered by the signature
    reply = miner.handle(forged)
    assert reply.status == "error" and "signature" in reply.error
    fresh = _signed(vkp, _request(vkp, "rp-1", 5))
    assert miner.handle(fresh).status == "ok"
    replay = miner.handle(fresh)
    assert replay.status == "error" and "replayed" in replay.error
    stranger = Keypair.from_seed(b"not-registered")
    refused = miner.handle(_signed(stranger, P.InferenceRequest(
        request_id="rp-2", prompt="p", width=32, height=32, num_frames=2, num_steps=2,
        validator_pubkey=stranger.public_bytes)))
    assert refused.status == "error" and "blacklisted" in refused.error


# --- across the two implementations --------------------------------------------


def _crossing(handler, outer, inner):
    """A handler of the ``inner`` package served on the ``outer`` package's
    transport: each message crosses as wire bytes, outer's encoding decoded
    by inner's, and the reply back the same way."""
    def serve(msg):
        reply = handler(inner.from_wire(outer.to_wire(msg)))
        return outer.from_wire(inner.to_wire(reply))
    return serve


BF16_ULP_AT_8 = 0.0625  # one bf16 ulp of z at |z| in [8, 16)
ATOL_CROSS = 5e-2       # the reference's cross-platform bound


class CrossRound(NamedTuple):
    """A round across the implementations: the validator, its report, the
    miners (uid i is miners[i]) and the prompt."""
    val: object
    report: dict
    miners: list
    prompt: str


def _bits(x) -> np.ndarray:
    """A bf16 array of either package as its int16 bits."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _bits_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint16).astype(np.uint32) << 16).view(np.float32)


def _refused_z(r: CrossRound, d: dict):
    """(the honest miner's committed z_{t+1} at the refused step, the
    validator's re-derivation of it), float32: the validator's package's
    ``verify_revealed_steps`` on its engine, run again on the miner's leaves
    at the report's spot-check indices, as the validator ran it."""
    com = r.miners[0]._proofs[r.report["request_id"]]
    zs, epss = _bits(com.zs), _bits(com.epss)
    ours = isinstance(r.val, Validator)
    if ours:
        native, verify = (lambda b: torch.from_numpy(b.copy()).view(torch.bfloat16),
                          verify_revealed_steps)
    else:
        native, verify = lambda b: b.view(ml_dtypes.bfloat16), jverify_revealed_steps
    checks, step = d["spotcheck_indices"], d["step"]
    wanted = set(checks) | {i + 1 for i in checks if i + 1 < len(zs)}
    leaves = {i: (int(com.timesteps[i]), native(zs[i]), native(epss[i])) for i in wanted}
    cfg = r.val.config
    _, z_next = verify(r.val.engine, r.prompt, "", leaves, checks, cfg.num_steps,
                       cfg.guidance_scale, same_platform=False, atol=ATOL_CROSS)
    return _bits_f32(zs[step + 1]), _bits_f32(_bits(z_next[checks.index(step)]))


def honest_or_known_refusal(r: CrossRound, what: str) -> bool:
    """The honest miner's (uid 0) report entry across implementations: True
    when it passed; False when the validator refused it with exactly ROADMAP
    §3.1's signature (printed): at ``reexecution``, on z_{t+1}, every
    element beyond the bound one bf16 ulp (0.0625) apart with |z| >= 8 on
    both sides (located by re-running the validator's re-execution), eps
    within the bound, every earlier check passed. Any other refusal fails
    the test."""
    d = r.report["miners"]["0"]
    if d.get("failed_check") != "reexecution":
        assert not d.get("cheat") and "failed_check" not in d, d
        return True
    assert d["reason"] == "z_{t+1} re-derivation mismatch" \
        and d["z_err"] == BF16_ULP_AT_8 and d["eps_err"] < ATOL_CROSS, d
    z_miner, z_val = _refused_z(r, d)
    err = np.abs(z_val - z_miner)
    over = err > ATOL_CROSS
    print(f"{what}: refused by the cross-platform bound (ROADMAP §3.1): step "
          f"{d['step']}, z_err {d['z_err']}, eps_err {d['eps_err']}; beyond the bound: "
          f"miner z {z_miner[over].tolist()}, validator z {z_val[over].tolist()}")  # pytest -rP
    assert err.max() == d["z_err"], (err.max(), d)  # the validator's own difference
    assert (err[over] == BF16_ULP_AT_8).all() and (np.abs(z_miner[over]) >= 8).all() \
        and (np.abs(z_val[over]) >= 8).all(), (z_miner[over], z_val[over])
    assert d["same_platform"] is False and d["regime_atol"] == ATOL_CROSS
    assert all(d["checks"][c] for c in ("echo", "identity", "timesteps", "signature",
                                        "authenticity", "merkle", "base_noise")), d
    return False


def _cross_round(miner_pipe, validator_pipe, torch_validator: bool, tmp, rid: str,
                 miner_classes=None, prompt: str = "a red ball", **cfg) -> CrossRound:
    """Miners of one package behind the other package's validator, every
    message crossing as wire bytes. The miners are
    honest then lazy unless ``miner_classes`` says otherwise; ``cfg``
    overrides the validator's configuration."""
    vpk, mpk = (P, JP) if torch_validator else (JP, P)
    reg, led, tr = ((Registry(), Ledger(), MockTransport()) if torch_validator
                    else (JRegistry(), JLedger(), JMockTransport()))
    vcls, vcfg, vkp = ((Validator, ValidatorConfig, Keypair) if torch_validator
                       else (JValidator, JValidatorConfig, JKeypair))
    val = vcls(validator_pipe, vkp.from_seed(b"validator"), reg, tr, led,
               vcfg(**_cfg(tmp, **cfg)))
    miner_reg, mkp = (JRegistry(), JKeypair) if torch_validator else (Registry(), Keypair)
    if miner_classes is None:
        miner_classes = (JMiner, JLazyMiner) if torch_validator else (Miner, LazyMiner)
    miner_reg.register(val.pubkey, "mock://validator", role="validator", stake=STAKE * 10)
    miners = []
    for i, cls in enumerate(miner_classes):
        miner = cls(miner_pipe, mkp.from_seed(f"miner-{i}".encode()), miner_reg)
        miners.append(miner)
        uid = reg.register(miner.pubkey, f"mock://m{i}", "miner", STAKE,
                           platform=miner.platform_tag)
        led.mint(f"miner-{uid}", STAKE)
        led.stake(f"miner-{uid}", STAKE)
        tr.serve(f"mock://m{i}", _crossing(miner.handle, vpk, mpk))
    val.register("mock://validator", stake=STAKE * 10)  # after the miners: uids 0, 1
    led.mint("user", 20000)
    led.deposit_and_commit("user", rid, __import__("hashlib").sha256(prompt.encode()).digest(),
                           20000)
    return CrossRound(val, _run(val.run_round(rid, prompt)), miners, prompt)


@pytest.fixture(scope="module")
def torch_miners_jax_validator(tiny_port, tiny_pipeline, tmp_path_factory):
    """Port miners (honest, lazy) behind the JAX validator."""
    return _cross_round(tiny_port, tiny_pipeline, False, tmp_path_factory.mktemp("jv"), "x-1")


@pytest.fixture(scope="module")
def jax_miners_torch_validator(tiny_port, tiny_pipeline, tmp_path_factory):
    """JAX miners (honest, lazy) behind the port's validator."""
    return _cross_round(tiny_pipeline, tiny_port, True, tmp_path_factory.mktemp("tv"), "x-2")


CROSS = ["torch_miners_jax_validator", "jax_miners_torch_validator"]


@pytest.mark.parametrize("direction", CROSS)
def test_cross_implementation_honest_miner_passes(direction, request):
    r = request.getfixturevalue(direction)
    val, report = r.val, r.report
    d = report["miners"]["0"]
    if not honest_or_known_refusal(r, direction):
        return
    assert all(d["checks"].values()) and d["checks"]["reexecution"] and \
        d["checks"]["video_binding"]
    assert d["same_platform"] is False and d["regime_atol"] == 5e-2
    print(f"{direction}: reexec_max_err {d['reexec_max_err']:.4g}")  # shown by pytest -rP
    assert d["score"] > 0.0
    assert val.ledger.requests[report["request_id"]].status == "distributed"


@pytest.mark.parametrize("direction", CROSS)
def test_cross_implementation_lazy_miner_caught(direction, request):
    r = request.getfixturevalue(direction)
    val, report = r.val, r.report
    d = report["miners"]["1"]
    assert d["failed_check"] == "reexecution" and d["cheat"] is True, d
    assert d["same_platform"] is False and d["regime_atol"] == 5e-2
    assert d["score"] == 0.0
    assert val.ledger.stake_of("miner-1") < STAKE


@pytest.mark.parametrize("torch_validator", [False, True])
def test_checkpoint_round_across_implementations(ckpt_pipes, torch_validator, tmp_path):
    """An honest miner of one package on the checkpoint passes the other
    package's validator on the same checkpoint, in the cross-platform regime,
    with the same BPE token ids on both sides."""
    ours, ref = ckpt_pipes
    prompt = "a red panda in a tree"
    assert ours.tokenizer is not None and ref.tokenizer is not None
    np.testing.assert_array_equal(ours.tokenize(["", prompt]), ref.tokenize(["", prompt]))
    miners = (ref, ours) if torch_validator else (ours, ref)
    r = _cross_round(*miners, torch_validator, tmp_path, "ckpt-1",
                     miner_classes=(JMiner,) if torch_validator else (Miner,), prompt=prompt)
    val, report = r.val, r.report
    d = report["miners"]["0"]
    if not honest_or_known_refusal(r, f"checkpoint round, torch validator {torch_validator}"):
        return
    assert all(d["checks"].values())
    assert d["same_platform"] is False and d["regime_atol"] == 5e-2
    print(f"checkpoint round, torch validator {torch_validator}: reexec_max_err "
          f"{d['reexec_max_err']:.4g}")  # shown by pytest -rP
    assert d["score"] > 0.0
    assert val.ledger.requests["ckpt-1"].status == "distributed"


@pytest.mark.parametrize("pin", ["torch-cpu", "torch-cuda"])
def test_jax_validator_regime_for_torch_pins(torch_miners_jax_validator, pin):
    val = torch_miners_jax_validator.val
    assert val._regime(pin) == (False, val.config.atol, "")


def test_validators_reports_read_alike(torch_miners_jax_validator,
                                       jax_miners_torch_validator):
    """A miner's entry, its checks and phases read alike in the JAX
    validator's report and in the port's, for the same outcome: the honest
    miners' entries and MD-VQS keys, and the lazy miners' refusals at
    ``reexecution``. An honest miner refused as ROADMAP §3.1 says
    (``honest_or_known_refusal``) is held against the other report's lazy
    miner, refused at the same check. A round in which no miner passed
    reports ``ledger_error`` (nothing to distribute), in both packages."""
    rounds = {"ref": torch_miners_jax_validator, "ours": jax_miners_torch_validator}
    ref, ours = rounds["ref"].report, rounds["ours"].report
    passed = {side: honest_or_known_refusal(r, f"{side} honest miner")
              for side, r in rounds.items()}
    for side, rep in (("ours", ours), ("ref", ref)):
        assert ("ledger_error" in rep) is not passed[side], (side, rep.get("ledger_error"))
    assert set(ours) - {"ledger_error"} == set(ref) - {"ledger_error"}
    pairs = [(ours["miners"]["1"], ref["miners"]["1"])]
    if passed["ours"] and passed["ref"]:
        pairs.append((ours["miners"]["0"], ref["miners"]["0"]))
    else:
        print("honest entries compared with the lazy refusals: passed", passed)
    pairs += [(ours["miners"]["0"], ref["miners"]["1"])] if not passed["ours"] else []
    pairs += [(ours["miners"]["1"], ref["miners"]["0"])] if not passed["ref"] else []
    for a, b in pairs:
        assert set(a) == set(b), set(a) ^ set(b)
        assert set(a["checks"]) == set(b["checks"])
        assert set(a["timings_s"]) == set(b["timings_s"])
    if passed["ours"] and passed["ref"]:
        a, b = ours["miners"]["0"], ref["miners"]["0"]
        assert set(a["mdvqs"]) == set(b["mdvqs"])
        assert set(a["mdvqs"]["timings_s"]) == set(b["mdvqs"]["timings_s"])


def test_bf16_step_gap_between_implementations(tiny_pipeline):
    """A measurement of what the cross-platform regime (atol 5e-2) must
    absorb between the two implementations' bf16 step programs, both on the
    CPU: the JAX package's zeroscope-tiny in bf16 records 3 steps and the
    port's, holding the same weights in bf16, re-executes them from the
    revealed z. Printed (pytest -rP): eps and z_{t+1} differences, and one
    bf16 ulp at the largest |z|. Asserted: the same schedule and base latent
    on both sides, finite differences."""
    import dataclasses

    from dvdx_tpu.models.unet3d import UNet3D as JUNet3D
    from dvdx_tpu.models.vae import VAEDecoder as JVAEDecoder
    from dvdx_tpu.pipelines.text2video import Pipeline as JPipeline
    from dvdx_tpu.verify import spotcheck as jspot
    from dvdx_tpu_torch.models.zoo import get_model_spec
    from dvdx_tpu_torch.verify import spotcheck as tspot

    def bf16(spec):
        return dataclasses.replace(spec, unet=dataclasses.replace(spec.unet, dtype="bfloat16"),
                                   vae=dataclasses.replace(spec.vae, dtype="bfloat16"))

    jspec = bf16(tiny_pipeline.spec)
    jax_pipe = JPipeline(spec=jspec, unet=JUNet3D(jspec.unet),
                         text_encoder=tiny_pipeline.text_encoder,
                         vae_decoder=JVAEDecoder(jspec.vae), params=tiny_pipeline.params)
    port = load_pipeline_params(build_pipeline(bf16(get_model_spec("zeroscope-tiny")),
                                               device="cpu"),
                                jax.tree.map(np.asarray, tiny_pipeline.params))
    assert next(port.unet.parameters()).dtype == torch.bfloat16
    gen = dict(seed=7, num_frames=4, height=32, width=32, num_steps=3, guidance_scale=7.5)
    _, jz, jeps, jt = jspot.StepEngine(jax_pipe).generate_recorded("a blue cube spinning", **gen)
    zs, epss = tspot.as_tensor(jz), tspot.as_tensor(jeps)
    teng = tspot.StepEngine(port)
    _, tz, _, tt = teng.generate_recorded("a blue cube spinning", **gen)
    np.testing.assert_array_equal(np.asarray(tt), np.asarray(jt))
    assert torch.equal(tz[0].view(torch.int16), zs[0].view(torch.int16))
    eps_re, z_re = teng.reexecute_steps("a blue cube spinning", "", list(zs), [0, 1, 2], 3, 7.5)
    eps_err = [tspot.compare_arrays(eps_re[i], epss[i], bitwise=False, atol=5e-2)[1]
               for i in range(3)]
    z_err = [tspot.compare_arrays(z_re[i], zs[i + 1], bitwise=False, atol=5e-2)[1]
             for i in range(2)]
    z_max = zs.float().abs().max().item()
    print(f"bf16 zeroscope-tiny, JAX record vs port re-execution (CPU): eps_err {eps_err} "
          f"z_next_err {z_err} (atol 5e-2) at max|eps| {epss.float().abs().max().item()} "
          f"max|z| {z_max}, one bf16 ulp there {2.0 ** (np.floor(np.log2(z_max)) - 7)}")
    assert all(np.isfinite(eps_err + z_err))
