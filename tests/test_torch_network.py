"""The port's framework-free network modules against the JAX package's.

Wire format: the two packages must emit the same bytes, because a request's
signature covers its wire encoding (``protocol.signing_bytes``): a JAX miner
verifies a torch validator's signature and the reverse. Every message type is
encoded by both with the same field values (numpy integers and floats coerced
by the port, Python ones given to the reference) and compared byte for byte.
Signatures, seeds, spot-check samples, registration messages and the raw
video container are compared exactly too. The ledger, registry and score
book are the port's copies of the reference's, run through the cases of
``tests/test_network.py`` and, step for step, beside the reference.
"""

import asyncio
import types

import numpy as np
import pytest
import torch

from dvdx_tpu.network import base as jbase
from dvdx_tpu.network import ledger as jledger
from dvdx_tpu.network import protocol as JP
from dvdx_tpu.network import transport as jtransport
from dvdx_tpu.network.validator import Validator as JValidator
from dvdx_tpu.network.validator import ValidatorConfig as JValidatorConfig
from dvdx_tpu.utils import video_io as jvideo
from dvdx_tpu.verify import proof as jproof
from dvdx_tpu_torch.network import base as tbase
from dvdx_tpu_torch.network import protocol as TP
from dvdx_tpu_torch.network import transport as ttransport
from dvdx_tpu_torch.network.ledger import Ledger, LedgerError, prompt_commitment
from dvdx_tpu_torch.utils import video_io as tvideo
from dvdx_tpu_torch.verify import proof as tproof

MESSAGE_TYPES = ("InferenceRequest", "InferenceResponse", "RevealRequest",
                 "RevealResponse", "Ping", "Pong")


def _messages(seed: int):
    """{type: (port kwargs with numpy scalars, reference kwargs, Python values)}."""
    rng = np.random.default_rng(seed)
    b = lambda n: rng.bytes(n)  # noqa: E731
    i64 = lambda hi=2 ** 62: rng.integers(0, hi)  # noqa: E731  (numpy int64)
    path = [(b(32), bool(rng.integers(2))) for _ in range(3)]
    fields = {
        "InferenceRequest": dict(
            request_id=f"req-{seed}", prompt="a red panda ✓", negative_prompt="blurry",
            width=i64(2000), height=np.int32(320), num_frames=np.int64(16), fps=8,
            num_steps=np.int16(25), guidance_scale=np.float64(7.5), seed=i64(),
            challenge=b(32), validator_pubkey=b(32), cfg_split=np.bool_(seed % 2),
            issued_at=np.float64(1.7e9 + seed), signature=b(64)),
        "InferenceResponse": dict(
            request_id=f"req-{seed}", status="ok", error="", video=b(1000),
            video_sha256=b(32), merkle_root=b(32), signature=b(64), miner_pubkey=b(32),
            challenge=b(32), seed=i64(), num_steps=np.int64(3),
            timesteps=list(np.array([981, 648, 315], np.int32)),
            latent_shape=[np.int64(4), 16, 16, np.int64(4)], latent_dtype="bfloat16",
            num_chunks=0, platform="torch-cpu", gen_time_s=np.float32(1.5),
            timings={"generate": np.float64(1.25), "encode_mp4": 0.5}),
        "RevealRequest": dict(request_id="r", merkle_root=b(32),
                              leaf_indices=list(np.array([0, 2, 3])),
                              validator_pubkey=b(32), issued_at=1.5e9, signature=b(64)),
        "RevealResponse": dict(request_id="r", status="ok", error="",
                               leaves=[(np.int64(2), 648, b(64), b(64), path)]),
        "Ping": dict(nonce=np.uint32(rng.integers(0, 2 ** 32))),
        "Pong": dict(nonce=rng.integers(0, 2 ** 32), pubkey=b(32), busy=np.bool_(True)),
    }

    def plain(v):
        if isinstance(v, (list, tuple)):
            return type(v)(plain(x) for x in v)
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        return v.item() if isinstance(v, np.generic) else v

    return {t: (kw, {k: plain(v) for k, v in kw.items()}) for t, kw in fields.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", MESSAGE_TYPES)
def test_wire_bytes_equal(name, seed):
    port_kw, ref_kw = _messages(seed)[name]
    port_msg = getattr(TP, name)(**port_kw)
    ref_msg = getattr(JP, name)(**ref_kw)
    wire = TP.to_wire(port_msg)
    assert wire == JP.to_wire(ref_msg)
    if hasattr(ref_msg, "signature"):
        assert TP.signing_bytes(port_msg) == JP.signing_bytes(ref_msg)
    # each side decodes the other's bytes to the same message
    back = TP.from_wire(JP.to_wire(ref_msg))
    assert TP.to_wire(back) == wire
    assert JP.to_wire(JP.from_wire(wire)) == wire


def test_wire_refuses_what_it_cannot_encode():
    with pytest.raises(TypeError):
        TP.to_wire(TP.Ping(nonce=np.zeros(2)))
    with pytest.raises(ValueError):
        TP.from_wire(b"garbage")
    with pytest.raises(ValueError):
        TP.from_wire(TP.to_wire(TP.Ping())[:-1])


def test_protocol_coerces_and_validates():
    req = TP.InferenceRequest(request_id="r", prompt="p", width="32", height=32,
                              num_frames=2, num_steps=2, seed="7")
    req.validate()
    assert req.width == 32 and req.seed == 7
    with pytest.raises(ValueError):
        TP.InferenceRequest(request_id="r", prompt="p", num_steps=0).validate()
    with pytest.raises(ValueError):
        TP.InferenceRequest(request_id="r", prompt="p", challenge=b"x").validate()


def test_signatures_cross_verify():
    """Ed25519 is deterministic: the same key signs 100 random messages to
    the same bytes in both packages, and each verifies the other's."""
    rng = np.random.default_rng(0)
    for i in range(100):
        seed = rng.bytes(16)
        tkp, jkp = tproof.Keypair.from_seed(seed), jproof.Keypair.from_seed(seed)
        assert tkp.public_bytes == jkp.public_bytes
        msg = rng.bytes(int(rng.integers(0, 300)))
        sig_t, sig_j = tkp.sign(msg), jkp.sign(msg)
        assert sig_t == sig_j
        assert jproof.verify_signature(tkp.public_bytes, msg, sig_t)
        assert tproof.verify_signature(jkp.public_bytes, msg, sig_j)
        bad = bytes([sig_t[0] ^ 1]) + sig_t[1:]
        assert not jproof.verify_signature(tkp.public_bytes, msg, bad)
        assert not tproof.verify_signature(jkp.public_bytes, msg, bad)


def test_signed_request_crosses_packages():
    """A torch validator's signed request verifies as the JAX miner checks
    it, and a JAX validator's as the port's miner checks it."""
    kp_t, kp_j = tproof.Keypair.from_seed(b"v"), jproof.Keypair.from_seed(b"v")
    t_req = TP.InferenceRequest(request_id="x", prompt="p", seed=np.int64(5),
                                challenge=b"\x01" * 32, validator_pubkey=kp_t.public_bytes,
                                issued_at=123.0)
    t_req.signature = kp_t.sign(TP.signing_bytes(t_req))
    j_req = JP.from_wire(TP.to_wire(t_req))
    assert jproof.verify_signature(j_req.validator_pubkey, JP.signing_bytes(j_req),
                                   j_req.signature)
    j_req2 = JP.RevealRequest(request_id="x", merkle_root=b"\x02" * 32, leaf_indices=[0, 1],
                              validator_pubkey=kp_j.public_bytes, issued_at=9.0)
    j_req2.signature = kp_j.sign(JP.signing_bytes(j_req2))
    t_req2 = TP.from_wire(JP.to_wire(j_req2))
    assert tproof.verify_signature(t_req2.validator_pubkey, TP.signing_bytes(t_req2),
                                   t_req2.signature)


@pytest.mark.parametrize("seed", range(5))
def test_proof_primitives_equal(seed):
    rng = np.random.default_rng(seed)
    key, challenge, root, secret = rng.bytes(32), rng.bytes(32), rng.bytes(32), rng.bytes(16)
    assert tproof.derive_seed(key, challenge) == jproof.derive_seed(key, challenge)
    for steps, k in ((25, 2), (3, 3), (50, 5), (1, 3)):
        assert (tproof.sample_spotcheck_indices(root, challenge, steps, k, secret=secret)
                == jproof.sample_spotcheck_indices(root, challenge, steps, k, secret=secret))
    video = rng.bytes(500)
    kp = tproof.Keypair.from_seed(key)
    sig = tproof.sign_proof(kp, challenge, 12345, video, root)
    assert sig == jproof.sign_proof(jproof.Keypair.from_seed(key), challenge, 12345, video, root)
    assert jproof.verify_proof_signature(kp.public_bytes, challenge, 12345, video, root, sig)
    assert not tproof.verify_proof_signature(kp.public_bytes, challenge, 12346, video, root,
                                             sig)
    reg_sig, ts = tproof.sign_registration(kp, "mock://m", "miner", "torch-cpu", 7)
    assert tproof.registration_message(kp.public_bytes, "mock://m", "miner", "torch-cpu",
                                       7, ts) == jproof.registration_message(
        kp.public_bytes, "mock://m", "miner", "torch-cpu", 7, ts)
    assert jproof.verify_registration_signature(kp.public_bytes, "mock://m", "miner",
                                                "torch-cpu", 7, ts, reg_sig)
    assert not tproof.verify_registration_signature(kp.public_bytes, "mock://m", "miner",
                                                    "torch-cpu", 7, ts, reg_sig,
                                                    now=ts + 601)
    with pytest.raises(ValueError):
        tproof.sample_spotcheck_indices(root, challenge, 25, 2, secret=b"")


@pytest.mark.parametrize("pin", ["torch-cpu", "torch-cuda"])
def test_jax_regime_puts_torch_pins_cross_platform(pin):
    """The JAX validator's regime for the port's pins: cross-platform, the
    5e-2 tolerance, no strategy."""
    cfg = JValidatorConfig()
    fake_self = types.SimpleNamespace(config=cfg)
    assert JValidator._regime(fake_self, pin) == (False, cfg.atol, "")


def test_raw_container_bytes_equal():
    frames = np.random.default_rng(3).integers(0, 256, (3, 8, 12, 3), dtype=np.uint8)
    raw = tvideo.encode_raw(frames, fps=8)
    assert raw == jvideo.encode_raw(frames, fps=8)
    np.testing.assert_array_equal(tvideo.decode_video(raw), frames)
    np.testing.assert_array_equal(jvideo.decode_video(raw), frames)


def test_mp4_bytes_equal_and_decode():
    """Both packages encode through the same codec call: the same bytes, and
    each decodes them to the same frames."""
    frames = np.random.default_rng(4).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    data = tvideo.encode_mp4(frames, fps=8)
    assert data == jvideo.encode_mp4(frames, fps=8)
    got = tvideo.decode_video(data)
    assert got.shape == frames.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jvideo.decode_video(data))


# --- ledger, registry, scores -------------------------------------------------


def test_ledger_full_lifecycle():
    led = Ledger()
    led.mint("user", 1000)
    led.mint("miner-0", 500)
    led.stake("miner-0", 500)
    led.deposit_and_commit("user", "r1", prompt_commitment("hi"), 1000)
    assert led.balance("user") == 0
    assert led.verify_prompt("r1", "hi")
    assert not led.verify_prompt("r1", "other")
    led.record_submission("validator", "r1", "miner-0", 0.8, b"proof")
    led.distribute_rewards("validator", "r1")
    assert led.claim("miner-0") == 700  # miner_split=0.7
    assert led.claim("validator") == 300
    assert led.requests["r1"].status == "distributed"


def test_ledger_access_control_and_refund():
    led = Ledger()
    led.mint("user", 100)
    led.deposit_and_commit("user", "r1", b"\x00" * 32, 100)
    with pytest.raises(LedgerError):
        led.record_submission("not-validator", "r1", "m", 1.0, b"")
    with pytest.raises(LedgerError):
        led.record_submission("validator", "r1", "unstaked-miner", 1.0, b"")
    with pytest.raises(LedgerError):
        led.slash_stake("not-validator", "m")
    with pytest.raises(LedgerError):
        led.distribute_rewards("validator", "r1")  # nothing submitted
    led.refund_unused("validator", "r1")
    assert led.balance("user") == 100
    with pytest.raises(LedgerError):
        led.refund_unused("validator", "r1")  # double refund
    with pytest.raises(LedgerError):
        led.deposit_and_commit("user", "r2", b"\x00" * 32, 1000)  # over balance


def test_ledger_slash():
    led = Ledger()
    led.mint("m", 1000)
    led.stake("m", 1000)
    cut = led.slash_stake("validator", "m")
    assert cut == 100 and led.stake_of("m") == 900


def test_ledger_set_weights_epoch_semantics():
    led = Ledger()
    for caller, uids, weights in (("not-validator", [0], [1]), ("validator", [0, 1], [1]),
                                  ("validator", [], []), ("validator", [3, 3], [1, 2]),
                                  ("validator", [0], [70000])):
        with pytest.raises(LedgerError):
            led.set_weights(caller, uids, weights)
    assert led.set_weights("validator", [0, 3], [65535, 1200]) == 1
    assert led.weight_of(0) == 65535 and led.weight_of(3) == 1200
    assert led.set_weights("validator", [3], [65535]) == 2
    assert led.weight_of(0) == 0 and led.weights_epoch == 2
    snap = led.snapshot()
    assert snap["weights_epoch"] == 2 and snap["weights"] == {3: 65535}
    assert [e.kind for e in led.events].count("Weights") == 2


def test_ledger_step_for_step_with_reference():
    """One sequence of operations on both ledgers: equal snapshots and event
    streams after every step."""
    ours, ref = Ledger(), jledger.Ledger()
    ops = [("mint", "user", 5000), ("mint", "miner-0", 800), ("mint", "miner-1", 800),
           ("stake", "miner-0", 800), ("stake", "miner-1", 600),
           ("deposit_and_commit", "user", "r1", prompt_commitment("a cat"), 3000),
           ("record_submission", "validator", "r1", "miner-0", 0.6, b"p0"),
           ("record_submission", "validator", "r1", "miner-1", 0.3, b"p1"),
           ("slash_stake", "validator", "miner-1", 0.25), ("advance_block", 3),
           ("distribute_rewards", "validator", "r1"), ("claim", "miner-0"),
           ("set_weights", "validator", [0, 1], [65535, 3000]),
           ("deposit_and_commit", "user", "r2", prompt_commitment("a dog"), 1000),
           ("refund_unused", "validator", "r2")]
    for name, *args in ops:
        assert getattr(ours, name)(*args) == getattr(ref, name)(*args)
        assert ours.snapshot() == ref.snapshot()
        assert [e.to_dict() for e in ours.events] == [e.to_dict() for e in ref.events]
    assert prompt_commitment("x") == jledger.prompt_commitment("x")


def test_registry_and_scorebook_match_reference():
    ours, ref = tbase.Registry(), jbase.Registry()
    rng = np.random.default_rng(5)
    for i in range(6):
        pk = bytes([i]) * 32
        args = (pk, f"mock://m{i}", "miner" if i else "validator", 100 * i,
                "torch-cpu" if i % 2 else "cpu")
        assert ours.register(*args) == ref.register(*args)
    ours.register(bytes([2]) * 32, "mock://moved", "miner", 50)  # re-registration
    ref.register(bytes([2]) * 32, "mock://moved", "miner", 50)
    for uid, caught in ((1, True), (2, False), (1, True), (3, False)):
        ours.update_trust(uid, caught)
        ref.update_trust(uid, caught)
    assert ours.to_json() == ref.to_json()
    assert (ours.sample_miner_uids(3, rng=__import__("random").Random(7), min_stake=1)
            == ref.sample_miner_uids(3, rng=__import__("random").Random(7), min_stake=1))

    book_t, book_j = tbase.ScoreBook(), jbase.ScoreBook()
    for _ in range(40):
        uid, reward = int(rng.integers(0, 12)), float(rng.random())
        book_t.update(uid, reward)
        book_j.update(uid, reward)
    assert book_t.weights() == book_j.weights()
    assert book_t.weights_u16() == book_j.weights_u16()


def test_mock_transport_round_trips_and_emulates_wan():
    assert {k: vars(v) for k, v in ttransport.WAN_PRESETS.items()} == \
        {k: vars(v) for k, v in jtransport.WAN_PRESETS.items()}
    seen = []

    def handler(msg):
        seen.append(msg)
        return TP.Pong(nonce=msg.nonce, pubkey=b"k" * 32)

    tr = ttransport.MockTransport(wan=ttransport.WAN_PRESETS["wifi"], seed=1)
    tr.serve("mock://a", handler)
    reply = asyncio.new_event_loop().run_until_complete(
        tr.request("mock://a", TP.Ping(nonce=np.int64(77)), timeout_s=30))
    assert isinstance(reply, TP.Pong) and reply.nonce == 77
    assert type(seen[0].nonce) is int  # decoded from the wire, not passed through
    assert tr.stats["emulated_delay_s"] > 0 and tr.stats["bytes_sent"] > 0
    tr.remove("mock://a")
    with pytest.raises(ttransport.TransportError):
        asyncio.new_event_loop().run_until_complete(tr.request("mock://a", TP.Ping()))


def test_leaf_bytes_round_trip_through_the_spool_views():
    """The miner's spool stores bf16 leaves as uint16 views and reads them
    back bit for bit, without ml_dtypes."""
    from dvdx_tpu_torch.network.miner import _bf16, _u16

    x = torch.randn(3, 4, 5).bfloat16()
    assert torch.equal(_bf16(_u16(x)).view(torch.int16), x.view(torch.int16))
