"""The port's deployment layer on the CPU: deposit listener, REST API, HTTP
transport and the services (``dvdx_tpu_torch/network/{deposit_listener,api,
http_transport,services}``), held against the JAX package's.

* The listener's flow, auto-refund and claim-vs-refund atomicity, as
  ``tests/test_services.py`` holds the JAX package's.
* The REST API: one request sequence sent to the JAX package's ``create_app``
  and to the port's, each over its own ledger, listener, registry and score
  book; every status code and body must be equal once the ``seen_at``
  timestamps are masked.
* ``ScoreBook`` state crosses the packages through ``save`` / ``load``.
* Rounds across the implementations over real HTTP on localhost (float32
  zeroscope-tiny, the same weights through ``utils.bridge``): the JAX
  validator with the JAX ``HttpTransport`` passes a port miner behind the
  port's ``serve_neuron``, and the port's validator passes a JAX miner, both
  in the cross-platform regime (atol 5e-2), or refuses it by exactly the
  open fault of ROADMAP §3.1 (one bf16 ulp of z at |z| >= 8).
* The services: ``run_validator`` and ``run_miner`` on port 0 in one event
  loop, from deposit to ``completed``; ``python -m dvdx_tpu_torch validator
  --cpu`` as a subprocess; the flags not ported yet refused.

Every server, thread and process here is torn down in a ``finally``, every
wait has its own deadline (``asyncio.wait_for``, subprocess timeouts), and
rounds ping with a 30 s timeout (``ping_timeout_s``, the services' config
patched to it) so that CPU load cannot drop a miner.
"""

import asyncio
import functools
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
from aiohttp import ClientSession, ClientTimeout

from dvdx_tpu.network import api as japi
from dvdx_tpu.network import base as jbase
from dvdx_tpu.network import deposit_listener as jlistener
from dvdx_tpu.network import http_transport as jhttp
from dvdx_tpu.network import ledger as jledger
from dvdx_tpu.network.miner import Miner as JMiner
from dvdx_tpu.network.validator import Validator as JValidator
from dvdx_tpu.network.validator import ValidatorConfig as JValidatorConfig
from dvdx_tpu.verify.proof import Keypair as JKeypair
from dvdx_tpu_torch.network import api as tapi
from dvdx_tpu_torch.network import base as tbase
from dvdx_tpu_torch.network import deposit_listener as tlistener
from dvdx_tpu_torch.network import http_transport as thttp
from dvdx_tpu_torch.network import ledger as tledger
from dvdx_tpu_torch.network import services
from dvdx_tpu_torch.network.miner import Miner
from dvdx_tpu_torch.network.validator import Validator, ValidatorConfig
from dvdx_tpu_torch.pipelines.text2video import build_pipeline
from dvdx_tpu_torch.utils.bridge import load_pipeline_params
from dvdx_tpu_torch.verify.proof import Keypair, sign_registration

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRY = dict(num_frames=2, width=32, height=32, num_steps=3)
STAKE = 10_000
DEADLINE_S = 240.0


def _run(coro, deadline_s: float = DEADLINE_S):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, deadline_s))
    finally:
        loop.close()


# --- the deposit listener ------------------------------------------------------


def test_deposit_listener_flow():
    led = tledger.Ledger()
    listener = tlistener.DepositListener(led, stuck_timeout_s=9999)
    led.mint("alice", 500)
    led.deposit_and_commit("alice", "r1", tledger.prompt_commitment("hello"), 500)
    listener.poll_once()
    assert listener.status_of("r1")["status"] == "pending"
    assert not listener.attach_prompt("r1", "wrong prompt")
    assert listener.attach_prompt("r1", "hello")
    assert listener.next_ready() == "r1"
    listener.set_status("r1", "completed")
    assert listener.next_ready() is None
    assert listener.metrics["deposits_seen"] == 1 and led.block == 1


def test_deposit_listener_auto_refund():
    led = tledger.Ledger()
    listener = tlistener.DepositListener(led, stuck_timeout_s=0.0)
    led.mint("bob", 100)
    led.deposit_and_commit("bob", "r2", b"\x01" * 32, 100)
    listener.poll_once()   # registers
    listener.poll_once()   # refunds (age > 0)
    assert listener.status_of("r2")["status"] == "refunded"
    assert led.balance("bob") == 100
    assert listener.metrics["auto_refunds"] == 1


def test_claim_next_ready_atomic_vs_refund():
    """A claimed request cannot be refunded; a queued one still can."""
    led = tledger.Ledger()
    listener = tlistener.DepositListener(led, stuck_timeout_s=9999)
    for i in (1, 2):
        led.mint("u", 100)
        led.deposit_and_commit("u", f"q-{i}", tledger.prompt_commitment(f"p{i}"), 100)
    listener.poll_once()
    assert listener.attach_prompt("q-1", "p1") and listener.attach_prompt("q-2", "p2")
    assert listener.claim_next_ready() == ("q-1", "p1")
    listener.stuck_timeout_s = 0.0
    listener.poll_once()
    assert listener.status_of("q-1")["status"] == "processing"
    assert listener.status_of("q-2")["status"] == "refunded"
    assert not listener.try_refund("q-1")
    assert led.balance("u") == 100
    assert listener.claim_next_ready() is None


def test_listener_thread_starts_and_stops():
    led = tledger.Ledger()
    listener = tlistener.DepositListener(led, poll_interval_s=0.01)
    listener.start()
    try:
        led.mint("u", 5)
        led.deposit_and_commit("u", "t-1", b"\x02" * 32, 5)
        deadline = time.time() + 10
        while listener.status_of("t-1") is None and time.time() < deadline:
            time.sleep(0.01)
        assert listener.status_of("t-1")["status"] == "pending"
    finally:
        listener.stop()
    assert not listener._thread.is_alive()


def test_ledger_event_log_and_burn():
    led = tledger.Ledger()
    led.mint("a", 10)
    led.advance_block()
    led.deposit_and_commit("a", "e-1", b"\x03" * 32, 4)
    assert [e.kind for e in led.events_from_index(0)] == ["Deposit"]
    assert led.events_from_index(1) == [] and len(led.events_since(1)) == 1
    assert led.events_since(2) == []
    led.burn("a", 6)
    assert led.balance("a") == 0
    with pytest.raises(tledger.LedgerError):
        led.burn("a", 1)


# --- registry and score book -----------------------------------------------------


def test_registry_replace_all_and_miners():
    src = tbase.Registry()
    src.register(b"\x01" * 32, "v:1", role="validator", stake=5)
    src.register(b"\x02" * 32, "m:1", stake=7, platform="torch-cuda")
    reg = tbase.Registry()
    reg.register(b"\x09" * 32, "old:1")
    reg.replace_all(json.loads(src.to_json()))
    assert reg.to_json() == src.to_json()
    assert [n.uid for n in reg.miners()] == [1] and reg.miners()[0].platform == "torch-cuda"
    assert reg.register(b"\x03" * 32, "m:2") == 2
    jreg = jbase.Registry()
    jreg.replace_all(json.loads(src.to_json()))
    assert jreg.to_json() == src.to_json()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_scorebook_npz_crosses_packages(tmp_path, direction):
    a, b = ((tbase.ScoreBook(), jbase.ScoreBook()) if direction == "port_to_jax"
            else (jbase.ScoreBook(), tbase.ScoreBook()))
    a.update_many([3, 0, 7], [0.9, 0.25, 0.0])
    a.update(3, 0.5)
    path = str(tmp_path / "validator_state.npz")
    a.save(path)
    b.load(path)
    assert b.scores == a.scores and b.weights() == a.weights()
    assert b.weights_u16() == a.weights_u16()
    b.handle_hotkey_swap(3)
    a.handle_hotkey_swap(3)
    assert b.scores == a.scores


# --- the REST API against the JAX package's ----------------------------------------


def _mask(body):
    if isinstance(body, dict):
        return {k: (None if k == "seen_at" else _mask(v)) for k, v in body.items()}
    if isinstance(body, list):
        return [_mask(v) for v in body]
    return body


def _api_steps():
    """The request sequence: (method, path, JSON body), or ("poll",) for one
    synchronous listener poll."""
    ph = tledger.prompt_commitment("make a video").hex()
    ukp = Keypair.from_seed(b"web-user")
    ph2 = tledger.prompt_commitment("signed prompt").hex()
    dep_sig = ukp.sign(f"dvdx-deposit|api-2|{ph2}|500".encode()).hex()
    mkp = Keypair.from_seed(b"reg-test")
    ts = int(time.time())
    sig, _ = sign_registration(mkp, "1.2.3.4:5", "miner", "torch-cpu", stake=7, timestamp=ts)
    old_sig, _ = sign_registration(mkp, "1.2.3.4:5", "miner", "", stake=7, timestamp=ts - 10_000)
    reg = {"pubkey": mkp.public_bytes.hex(), "address": "1.2.3.4:5", "stake": 7,
           "platform": "torch-cpu", "timestamp": ts, "signature": sig.hex()}
    return [
        ("GET", "/health", None), ("GET", "/", None), ("GET", "/status.html", None),
        ("POST", "/deposit", {"user": "carol", "request_id": "api-1", "prompt_hash": ph,
                              "amount": 1000}),
        ("poll",),
        ("POST", "/submit_prompt", {"request_id": "api-1", "prompt": "different"}),
        ("POST", "/submit_prompt", {"request_id": "api-1", "prompt": "make a video"}),
        ("POST", "/submit_prompt", {"request_id": "api-1"}),
        ("POST", "/submit_prompt", {"request_id": "never", "prompt": "x"}),
        ("GET", "/status/api-1", None), ("GET", "/status/unknown", None),
        ("GET", "/result/api-1", None), ("GET", "/result/old-9", None),
        ("GET", "/videos/old-9_miner0.mp4", None), ("GET", "/videos/nope.mp4", None),
        ("POST", "/refund/api-1", None), ("POST", "/refund/api-1", None),
        ("POST", "/refund/nobody", None),
        ("GET", "/requests", None),
        ("POST", "/deposit", {"user": "ignored", "request_id": "api-2", "prompt_hash": ph2,
                              "amount": 500, "pubkey": ukp.public_bytes.hex(),
                              "signature": dep_sig}),
        ("POST", "/deposit", {"user": "x", "request_id": "api-3", "prompt_hash": ph2,
                              "amount": 500, "pubkey": ukp.public_bytes.hex(),
                              "signature": "00" * 64}),
        ("POST", "/deposit", {"user": "x", "request_id": "api-2", "prompt_hash": ph2,
                              "amount": 5}),
        ("POST", "/deposit", {"user": "x", "request_id": "api-4", "prompt_hash": "zz",
                              "amount": 5}),
        ("poll",),
        ("POST", "/register", reg),
        ("POST", "/register", {"pubkey": "aa" * 32, "address": "1.2.3.4:5", "stake": 7}),
        ("POST", "/register", dict(reg, platform="cpu")),
        ("POST", "/register", dict(reg, stake=10**9)),
        ("POST", "/register", dict(reg, platform="", timestamp=ts - 10_000,
                                   signature=old_sig.hex())),
        ("POST", "/register", {"pubkey": None, "address": "1.2.3.4:5"}),
        ("POST", "/register", dict(reg, stake=-1)),
        ("POST", "/register", dict(reg, address=5)),
        ("GET", "/registry", None), ("GET", "/weights", None),
        ("GET", "/requests", None), ("GET", "/health", None),
    ]


async def _exchange(pkg, results_dir: str, steps):
    """Drive one package's REST API through ``steps`` -> [(method, path,
    status, body)]."""
    api, base, listener_mod, ledger_mod = pkg
    led = ledger_mod.Ledger()
    listener = listener_mod.DepositListener(led, stuck_timeout_s=9999)
    reg = base.Registry()
    book = base.ScoreBook()
    book.update_many([0, 1], [0.8, 0.3])
    led.set_weights("validator", [0, 1], [65535, 20000])
    app = api.create_app(led, listener, reg, results_dir=results_dir, submit_wait_s=0.5)
    app["scorebook"] = book
    runner, port = await api.serve_api(app, port=0)
    out = []
    try:
        async with ClientSession(timeout=ClientTimeout(total=30)) as sess:
            for step in steps:
                if step[0] == "poll":
                    listener.poll_once()
                    continue
                method, path, body = step
                async with sess.request(method, f"http://127.0.0.1:{port}{path}",
                                        json=body) as r:
                    if r.content_type == "application/json":
                        payload = _mask(await r.json())
                    else:
                        payload = (r.content_type, await r.read())
                    out.append((method, path, r.status, payload))
    finally:
        await runner.cleanup()
    return out


def test_rest_api_responses_equal_jax_package(tmp_path):
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        (d / "results_old-9.json").write_text(json.dumps({
            "request_id": "old-9", "miners": {
                "0": {"score": 0.42, "video_path": "x/old-9_miner0.mp4"},
                "1": {"score": 0.0, "cheat": True}}}))
        (d / "old-9_miner0.mp4").write_bytes(b"\x00\x01mp4-bytes")
    steps = _api_steps()
    ref = _run(_exchange((japi, jbase, jlistener, jledger), str(tmp_path / "jax"), steps))
    ours = _run(_exchange((tapi, tbase, tlistener, tledger), str(tmp_path / "port"), steps))
    assert len(ours) == len(ref) == len([s for s in steps if s[0] != "poll"])
    for got, want in zip(ours, ref):
        assert got == want, (got, want)
    statuses = {(m, p): s for m, p, s, _ in ours}
    assert statuses[("GET", "/status.html")] == 200 and statuses[("POST", "/register")] == 400
    assert ours[-3][3]["onchain"] == {"epoch": 1, "weights": {"0": 65535, "1": 20000}}


# --- rounds across the implementations over HTTP ---------------------------------------


@pytest.fixture(scope="module")
def tiny_port(tiny_pipeline):
    """The port's zeroscope-tiny holding the reference's perturbed weights."""
    tree = jax.tree.map(np.asarray, tiny_pipeline.params)
    return load_pipeline_params(build_pipeline("zeroscope-tiny", device="cpu"), tree)


async def _http_round(validator_side, miner_side, tmp, rid: str, prompt: str):
    """One honest miner of ``miner_side`` served over HTTP on localhost, one
    round of ``validator_side``'s validator over its own HttpTransport ->
    (validator, report)."""
    vpipe, Val, VCfg, VReg, VLed, VKp, VHttp = validator_side
    mpipe, Min, MReg, MKp, MHttp = miner_side
    reg, led, transport = VReg.Registry(), VLed.Ledger(), VHttp.HttpTransport()
    val = Val(vpipe, VKp.from_seed(b"validator"), reg, transport, led,
              VCfg(sample_size=1, num_checkpoints=3, ping_timeout_s=30, timeout_s=120,
                   results_dir=str(tmp), **GEOMETRY))
    miner_reg = MReg.Registry()
    miner = Min(mpipe, MKp.from_seed(b"miner-0"), miner_reg)
    miner_reg.register(val.pubkey, "validator", role="validator", stake=STAKE * 10)
    runner, port = await MHttp.serve_neuron(miner.handle, "127.0.0.1", 0)
    try:
        uid = reg.register(miner.pubkey, f"127.0.0.1:{port}", "miner", STAKE,
                           platform=miner.platform_tag)
        led.mint(f"miner-{uid}", STAKE)
        led.stake(f"miner-{uid}", STAKE)
        val.register("validator", stake=STAKE * 10)
        led.mint("user", 20000)
        led.deposit_and_commit("user", rid, hashlib.sha256(prompt.encode()).digest(), 20000)
        report = await val.run_round(rid, prompt)
    finally:
        await transport.close()
        await runner.cleanup()
    return val, report


JAX_VALIDATOR = "jax_validator_port_miner"
PORT_VALIDATOR = "port_validator_jax_miner"


@pytest.mark.parametrize("direction", [JAX_VALIDATOR, PORT_VALIDATOR])
def test_cross_implementation_round_over_http(direction, tiny_pipeline, tiny_port, tmp_path):
    jax_side_v = (tiny_pipeline, JValidator, JValidatorConfig, jbase, jledger, JKeypair, jhttp)
    port_side_v = (tiny_port, Validator, ValidatorConfig, tbase, tledger, Keypair, thttp)
    jax_side_m = (tiny_pipeline, JMiner, jbase, JKeypair, jhttp)
    port_side_m = (tiny_port, Miner, tbase, Keypair, thttp)
    v, m = ((jax_side_v, port_side_m) if direction == JAX_VALIDATOR
            else (port_side_v, jax_side_m))
    val, report = _run(_http_round(v, m, tmp_path, f"http-{direction}", "a blue cube spinning"))
    d = report["miners"]["0"]
    assert val.transport.stats["requests"] >= 3  # ping, inference, reveal
    assert d["same_platform"] is False and d["regime_atol"] == 5e-2
    if d.get("failed_check") == "reexecution":
        # ROADMAP §3.1, open: the leaves are bf16 even for this float32 model,
        # so the two implementations' z_{t+1} can round to neighbouring bf16
        # values, and at |z| in [8, 16) one ulp (0.0625) exceeds the
        # reference's atol 5e-2; the seed comes from a random challenge, and
        # about 1 round in 8 meets it. The refusal must be exactly that; any
        # other failure is the wire's or the protocol's.
        print(f"{direction}: refused by the cross-platform bound (ROADMAP §3.1): "
              f"step {d['step']}, z_err {d['z_err']}, eps_err {d['eps_err']}")
        assert d["reason"] == "z_{t+1} re-derivation mismatch" and d["z_err"] == 0.0625 \
            and d["eps_err"] <= 5e-2, d
        assert all(d["checks"][c] for c in ("echo", "identity", "timesteps", "signature",
                                            "authenticity", "merkle", "base_noise"))
        return
    assert not d.get("cheat") and "failed_check" not in d, d
    assert all(d["checks"].values()) and d["checks"]["reexecution"] and \
        d["checks"]["video_binding"]
    assert d["score"] > 0.0
    assert val.ledger.requests[report["request_id"]].status == "distributed"
    print(f"{direction}: reexec_max_err {d['reexec_max_err']:.4g}")  # pytest -rP


def test_http_transport_refuses_a_bad_frame(tiny_port):
    """Ping and health over HTTP; a bad frame is a 400 and an unhandled
    message a 500; the miner's priority is its caller's stake."""
    async def go():
        kp = Keypair.from_seed(b"http-miner")
        miner = Miner(tiny_port, kp, tbase.Registry())
        vkp = Keypair.from_seed(b"http-validator")
        miner.registry.register(vkp.public_bytes, "v", role="validator", stake=77)
        assert miner.priority(vkp.public_bytes) == 77.0 and miner.priority(b"\x01" * 32) == 0.0
        runner, port = await thttp.serve_neuron(miner.handle, port=0)
        t = thttp.HttpTransport()
        try:
            from dvdx_tpu_torch.network import protocol as P

            pong = await t.request(f"127.0.0.1:{port}", P.Ping(nonce=5), timeout_s=30)
            assert isinstance(pong, P.Pong) and pong.nonce == 5 and pong.pubkey == kp.public_bytes
            async with ClientSession() as sess:
                async with sess.post(f"http://127.0.0.1:{port}/dvdx", data=b"junk") as r:
                    assert r.status == 400
                async with sess.get(f"http://127.0.0.1:{port}/health") as r:
                    assert (await r.json()) == {"status": "ok"}
            with pytest.raises(RuntimeError, match="500"):
                await t.request(f"127.0.0.1:{port}", P.Pong(nonce=1), timeout_s=30)
        finally:
            await t.close()
            await runner.cleanup()

    _run(go(), 60)


# --- the services ------------------------------------------------------------------------


async def _poll_json(sess, url: str, until, deadline_s: float, interval: float = 0.1):
    deadline = time.time() + deadline_s
    while True:
        try:
            async with sess.get(url) as r:
                body = await r.json()
                if until(body):
                    return body
        except Exception:  # not serving yet
            pass
        if time.time() > deadline:
            raise TimeoutError(f"{url}: condition not met in {deadline_s} s")
        await asyncio.sleep(interval)


def test_services_in_process_round(tmp_path, monkeypatch):
    """run_validator and run_miner (zeroscope-tiny on the CPU, port 0) in one
    event loop: the miner registers, a request goes through /deposit and
    /submit_prompt to ``completed``, the miner passes bit for bit in the
    same-program regime, and the validator's state npz loads into the JAX
    package's ScoreBook."""
    monkeypatch.chdir(tmp_path)  # the miner writes miner_metrics.json here
    monkeypatch.setattr(services, "ValidatorConfig",
                        functools.partial(ValidatorConfig, ping_timeout_s=30))
    results = str(tmp_path / "results")
    vargs = services.parse_args(
        ["--cpu", "validator", "--api-port", "0", "--perturb", "--width", "32",
         "--height", "32", "--frames", "2", "--steps", "3", "--sample-size", "1",
         "--num-checkpoints", "2", "--poll-interval", "0.05", "--results-dir", results])
    assert vargs.device == "cpu" and vargs.model == "zeroscope-tiny"

    async def go():
        api_port = asyncio.get_running_loop().create_future()
        vtask = asyncio.create_task(services.run_validator(vargs, api_port.set_result))
        tasks = [vtask]
        try:
            port = await asyncio.wait_for(asyncio.shield(api_port), 120)
            margs = services.parse_args(
                ["miner", "--cpu", "--port", "0", "--validator-api", f"127.0.0.1:{port}",
                 "--perturb", "--sync-interval", "0.2", "--spool-dir", ""])
            tasks.append(asyncio.create_task(services.run_miner(margs)))
            base = f"http://127.0.0.1:{port}"
            async with ClientSession(timeout=ClientTimeout(total=60)) as sess:
                reg = await _poll_json(sess, f"{base}/registry", lambda b: any(
                    n["role"] == "miner" for n in b.values()), 120)
                prompt = "a red ball bouncing"
                async with sess.post(f"{base}/deposit", json={
                        "user": "u", "request_id": "svc-1", "amount": 1000,
                        "prompt_hash": hashlib.sha256(prompt.encode()).hexdigest()}) as r:
                    assert r.status == 200
                async with sess.post(f"{base}/submit_prompt", json={
                        "request_id": "svc-1", "prompt": prompt}) as r:
                    assert r.status == 200, await r.text()
                status = await _poll_json(sess, f"{base}/status/svc-1", lambda b: b.get(
                    "status") in ("completed", "failed"), 180)
                async with sess.get(f"{base}/result/svc-1") as r:
                    result = await r.json()
                async with sess.get(f"{base}/weights") as r:
                    weights = await r.json()
            return reg, status, result, weights
        finally:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

    reg, status, result, weights = _run(go())
    miners = [uid for uid, n in reg.items() if n["role"] == "miner"]
    assert [reg[u]["platform"] for u in miners] == ["torch-cpu"]
    assert status["status"] == "completed", result
    d = result["miners"][miners[0]]
    assert all(d["checks"].values()) and d["same_platform"] is True
    assert d["reexec_bitwise"] is True and d["score"] > 0
    assert d["mdvqs"]["perceptual_metric"] == "random-projection-proxy"
    assert d["video_url"] == f"/videos/svc-1_miner{miners[0]}.mp4"
    assert weights["weights"] == {miners[0]: 1.0}
    book = jbase.ScoreBook()
    book.load(os.path.join(results, "validator_state.npz"))
    assert book.scores == {int(miners[0]): pytest.approx(0.1 * d["score"])}
    with open(tmp_path / "miner_metrics.json") as f:
        metrics = json.load(f)
    assert metrics["requests"] >= 1 and set(metrics["kernel_launches"]) >= {"flash_attention"}


def test_validator_service_subprocess(tmp_path):
    """``python -m dvdx_tpu_torch validator --cpu`` as its own process: it
    serves the API, takes a deposit and its prompt, and with no miner
    registered marks the request failed."""
    log = tmp_path / "validator.log"
    cmd = [sys.executable, "-m", "dvdx_tpu_torch", "validator", "--cpu", "--api-port", "0",
           "--poll-interval", "0.1", "--results-dir", str(tmp_path / "results"),
           "--width", "32", "--height", "32", "--frames", "2", "--steps", "2"]
    with open(log, "w") as out:
        proc = subprocess.Popen(cmd, cwd=str(tmp_path), stdout=out, stderr=subprocess.STDOUT,
                                env={**os.environ, "PYTHONPATH": REPO})
    try:
        deadline = time.time() + 120
        port = None
        while port is None:
            assert proc.poll() is None, log.read_text()
            m = re.search(r"REST API at 127\.0\.0\.1:(\d+)", log.read_text())
            if m:
                port = int(m.group(1))
            elif time.time() > deadline:
                raise TimeoutError(log.read_text())
            else:
                time.sleep(0.1)

        async def go():
            base = f"http://127.0.0.1:{port}"
            async with ClientSession(timeout=ClientTimeout(total=30)) as sess:
                async with sess.get(f"{base}/health") as r:
                    health = await r.json()
                async with sess.post(f"{base}/deposit", json={
                        "user": "u", "request_id": "sub-1", "amount": 10,
                        "prompt_hash": hashlib.sha256(b"p").hexdigest()}) as r:
                    assert r.status == 200
                async with sess.post(f"{base}/submit_prompt", json={
                        "request_id": "sub-1", "prompt": "p"}) as r:
                    assert r.status == 200
                status = await _poll_json(sess, f"{base}/status/sub-1", lambda b: b.get(
                    "status") in ("completed", "failed"), 60)
            return health, status

        health, status = _run(go(), 90)
        assert health["status"] == "ok" and health["miners"] == 0
        assert status["status"] == "failed"
        assert "device cpu" in log.read_text() or "on cpu" in log.read_text()
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=15)


@pytest.mark.parametrize("argv,item", [
    (["miner", "--params-ckpt", "ckpt"], "tensorstore"),
    (["validator", "--params-ckpt", "ckpt"], "tensorstore"),
])
def test_unported_flags_refused(argv, item, capsys, monkeypatch):
    """--params-ckpt reads orbax checkpoints through tensorstore; where that
    module does not import, the service refuses the flag with exit 2 and
    names the module, rather than serve other weights."""
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    assert services.main(argv) == 2
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("argv,tag", [
    (["miner", "--cpu", "--mesh-strategy", "hybrid_ctx"], "torch-cpu:hybrid_ctx"),
    (["miner", "--cpu", "--mesh", "1,1,1"], "torch-cpu:fsdp"),
    (["miner", "--cpu", "--mesh", "1,1,1", "--mesh-strategy", "cp_exact"],
     "torch-cpu:cp_exact"),
])
def test_mesh_flags_build_a_strategy_miner(argv, tag):
    """--mesh (a one-rank gloo group here) and --mesh-strategy give the
    service's miner that strategy's engine and pin."""
    import torch.distributed as dist

    from dvdx_tpu_torch.pipelines.text2video import build_pipeline
    from dvdx_tpu_torch.verify.proof import Keypair

    args = services.parse_args(argv)
    pipe = build_pipeline("zeroscope-tiny", device="cpu")
    try:
        miner = services.build_miner(args, pipe, Keypair.from_seed(b"m"), services.Registry())
        assert miner.platform_tag == tag
        assert (miner.engine.mesh is not None) == bool(args.mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("argv,device", [
    (["miner"], "cuda"), (["validator"], "cuda"), (["--cpu", "miner"], "cpu"),
    (["miner", "--cpu"], "cpu"), (["validator", "--device", "cpu"], "cpu"),
    (["--device", "cpu", "validator"], "cpu")])
def test_device_flags(argv, device):
    """The card unless --cpu / --device cpu, given before or after the role."""
    assert services.parse_args(argv).device == device
