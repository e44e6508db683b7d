"""The port's EVM bridge (``dvdx_tpu_torch/utils/keccak.py``,
``dvdx_tpu_torch/network/chain.py``) against the JAX package's.

* keccak-256: the known vectors, and the same digests as the JAX package's
  copy on inputs around the 136-byte rate;
* ABI encoding: the same bytes as ``dvdx_tpu.network.chain.encode_call`` for
  every entry point of ``evm/DVDXRewards.sol``;
* calldata: the exact transactions against a scripted JSON-RPC server (the
  one of ``tests/test_chain.py``), and a port validator round settled on it;
* end states: the port's ``ChainLedger`` and the JAX one, each driving its
  own ``evm/mocknode.py`` node through the same event sequence, leave the
  two nodes in identical states, and both match the in-process ledger.
"""

import asyncio
import hashlib
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from dvdx_tpu.network import chain as jchain
from dvdx_tpu.utils import keccak as jkeccak
from dvdx_tpu_torch.network import chain as tchain
from dvdx_tpu_torch.network.chain import ChainLedger, encode_call, request_id_to_bytes32
from dvdx_tpu_torch.network.ledger import Ledger, LedgerError, prompt_commitment
from dvdx_tpu_torch.utils.keccak import event_topic, keccak256, selector
from evm.mocknode import MockNode, serve

VALIDATOR = "0x" + "11" * 20
MINER = "0x" + "22" * 20
USER = "0x" + "33" * 20
CONTRACT = "0x" + "c0" * 20


def test_keccak256_vectors():
    assert keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
    assert keccak256(b"abc").hex() == (
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45")
    assert keccak256(b"The quick brown fox jumps over the lazy dog").hex() == (
        "4d741b6f1eb29cb2a9b9911c82f56fa8d73b04959d3d9d222895df6c0b28aa15")
    assert selector("transfer(address,uint256)").hex() == "a9059cbb"
    assert event_topic("Transfer(address,address,uint256)").hex() == (
        "ddf252ad1be2c89b69c2b068fc378daa952ba7f163c4a11628f55a4df523b3ef")


@pytest.mark.parametrize("n", [0, 1, 135, 136, 137, 271, 272, 300])
def test_keccak256_equals_jax_package(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert keccak256(data) == jkeccak.keccak256(data)


CALLS = [
    ("depositAndCommit(bytes32,bytes32,uint256)",
     [request_id_to_bytes32("r1"), prompt_commitment("p"), 10_000]),
    ("stake(uint256)", [1_000]),
    ("recordSubmission(bytes32,address,uint32,bytes32)",
     [request_id_to_bytes32("r1"), MINER, 875, b"\x07" * 32]),
    ("distributeRewards(bytes32)", [request_id_to_bytes32("r1")]),
    ("slashStake(address)", [MINER]),
    ("refundUnused(bytes32)", [request_id_to_bytes32("r2")]),
    ("claimReward()", []),
    ("setWeights(uint16[],uint16[])", [[0, 3], [65535, 1200]]),
    ("setWeights(uint16[],uint16[])", [[], []]),
    ("requestUnstake(uint256)", [2**255]),
    ("withdrawStake()", []),
    ("stakes(address)", [USER]),
    ("weightOf(uint16)", [3]),
]


@pytest.mark.parametrize("signature,args", CALLS)
def test_abi_bytes_equal_jax_package(signature, args):
    assert encode_call(signature, args) == jchain.encode_call(signature, args)


def test_abi_refusals():
    for bad in (("stake(uint256)", [1, 2]), ("f(bytes)", [b"dyn"]),
                ("stake(uint256)", [-1]), ("slashStake(address)", ["0x12"])):
        with pytest.raises(ValueError):
            encode_call(*bad)
        with pytest.raises(ValueError):
            jchain.encode_call(*bad)
    assert request_id_to_bytes32("req-1") == jchain.request_id_to_bytes32("req-1")


# --- the scripted JSON-RPC endpoint of tests/test_chain.py ----------------------


class _RpcHandler(BaseHTTPRequestHandler):
    store = None

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        method, params = body["method"], body["params"]
        if method == "eth_sendTransaction":
            self.store["txs"].append(params[0])
            result = "0x" + ("ab" * 32)
        elif method == "eth_getTransactionReceipt":
            result = {"status": "0x1"}
        elif method == "eth_call":
            result = self.store["calls"].get(params[0]["data"][:10], "0x" + "00" * 32)
        else:
            result = None
        out = json.dumps({"jsonrpc": "2.0", "id": body["id"], "result": result}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, *a):
        pass


@pytest.fixture()
def rpc_server():
    store = {"txs": [], "calls": {}}
    _RpcHandler.store = store
    srv = HTTPServer(("127.0.0.1", 0), _RpcHandler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{srv.server_port}", store
    finally:
        srv.shutdown()
        srv.server_close()


def _scripted(url, mod):
    return mod.ChainLedger(url, contract="0x" + "aa" * 20, validator_address=VALIDATOR,
                           accounts={"miner-0": MINER, "user": USER})


def _drive(led):
    root = hashlib.sha256(b"trace").digest()
    led.deposit_and_commit("user", "req-1", prompt_commitment("p"), 10_000)
    led.stake("miner-0", 1_000)
    led.record_submission("validator", "req-1", "miner-0", 0.875, root + b"sig-tail")
    led.distribute_rewards("validator", "req-1")
    led.slash_stake("validator", "miner-0")
    led.set_weights("validator", [1, 2], [100, 200])
    led.refund_unused("validator", "req-2")
    led.claim("miner-0")
    led.request_unstake("miner-0", 500)
    led.withdraw_stake("miner-0")


def test_exact_calldata_equals_jax_package(rpc_server):
    url, store = rpc_server
    _drive(_scripted(url, tchain))
    ours = list(store["txs"])
    store["txs"].clear()
    _drive(_scripted(url, jchain))
    assert ours == store["txs"]
    rid = request_id_to_bytes32("req-1")
    assert ours[2]["data"] == "0x" + encode_call(
        "recordSubmission(bytes32,address,uint32,bytes32)",
        [rid, MINER, 875, hashlib.sha256(b"trace").digest()]).hex()
    assert [t["from"] for t in ours] == [USER, MINER, VALIDATOR, VALIDATOR, VALIDATOR,
                                         VALIDATOR, VALIDATOR, MINER, MINER, MINER]


def test_reads_and_errors(rpc_server):
    url, store = rpc_server
    led = ChainLedger(url, contract="0x" + "aa" * 20, validator_address=VALIDATOR,
                      accounts={"miner-0": MINER})
    store["calls"]["0x" + selector("stakes(address)").hex()] = "0x" + "%064x" % 5000
    assert led.stake_of("miner-0") == 5000
    with pytest.raises(LedgerError):
        led.record_submission("validator", "r", "unknown-account", 1.0, b"")
    with pytest.raises(LedgerError):
        led.mint("miner-0", 10)


def test_port_validator_round_settles_on_chain(rpc_server, tmp_path):
    """A port mock-network round (zeroscope-tiny on the CPU, an honest and a
    lazy miner) with the chain ledger: the slash, the honest submission,
    the distribution and the weights land as transactions."""
    from dvdx_tpu_torch.network.mock import build_mock_network
    from dvdx_tpu_torch.network.validator import ValidatorConfig

    url, store = rpc_server
    cfg = ValidatorConfig(sample_size=2, num_checkpoints=2, num_frames=2, width=32,
                          height=32, num_steps=3, ping_timeout_s=30,
                          results_dir=str(tmp_path))
    net = build_mock_network(n_miners=2, adversaries=["lazy"], validator_config=cfg,
                             device="cpu")
    net.validator.ledger = ChainLedger(url, contract="0x" + "aa" * 20,
                                       validator_address=VALIDATOR,
                                       accounts={"miner-0": MINER,
                                                 "miner-1": "0x" + "44" * 20})
    loop = asyncio.new_event_loop()
    try:
        report = loop.run_until_complete(
            asyncio.wait_for(net.validator.run_round("req-chain", "a glass of water"), 120))
    finally:
        loop.close()
    sent = [t["data"][:10] for t in store["txs"]]
    for sig in ("slashStake(address)", "recordSubmission(bytes32,address,uint32,bytes32)",
                "distributeRewards(bytes32)", "setWeights(uint16[],uint16[])"):
        assert "0x" + selector(sig).hex() in sent, sig
    assert report["miners"]["0"]["failed_check"] == "reexecution"
    honest = report["miners"]["1"]
    assert honest["score"] > 0 and not honest.get("cheat")


# --- end states on the mock node: port vs JAX ChainLedger -----------------------


def _node_state(n: MockNode) -> dict:
    c = n.contract
    return {"tao": dict(n.tao.balances), "stakes": dict(c.stakes),
            "claimable": dict(c.claimable), "unbonding": dict(c.unbonding),
            "requests": {k.hex(): dict(v) for k, v in c.requests.items()},
            "weights_epoch": c.weights_epoch, "weight_of": dict(c.weight_of),
            "timestamp": n.timestamp, "block": n.block}


def _replay(mod):
    """The event sequence (the difftest script plus weights, a refund, an
    unbonding) on a fresh node -> (node state, reads through the ledger)."""
    node = MockNode(CONTRACT, VALIDATOR)
    node.mint(MINER, 1_000)
    node.mint(USER, 20_000)
    srv, p = serve(node, 0)
    try:
        led = mod.ChainLedger(f"http://127.0.0.1:{p}", CONTRACT, validator_address=VALIDATOR,
                              accounts={"miner-0": MINER, "user": USER})
        led.stake("miner-0", 1_000)
        led.deposit_and_commit("user", "r1", prompt_commitment("p"), 10_000)
        led.deposit_and_commit("user", "r2", prompt_commitment("q"), 5_000)
        led.record_submission("validator", "r1", "miner-0", 0.8, b"\x00" * 32)
        led.distribute_rewards("validator", "r1")
        led.slash_stake("validator", "miner-0")
        led.refund_unused("validator", "r2")
        led.set_weights("validator", [0, 3], [65535, 1200])
        led.set_weights("validator", [3], [65535])
        led.request_unstake("miner-0", 400)
        with pytest.raises(Exception):      # still unbonding
            led.withdraw_stake("miner-0")
        led.claim("miner-0")
        reads = {"stake": led.stake_of("miner-0"), "claimable_v": led.claimable_of("validator"),
                 "status": [led.request_status(r) for r in ("r1", "r2")],
                 "epoch": led.weights_epoch(), "w": [led.weight_of(u) for u in (0, 3)],
                 "count": led.weight_uid_count(),
                 "prompt": [led.verify_prompt("r1", "p"), led.verify_prompt("r1", "x")]}
        return _node_state(node), reads
    finally:
        srv.shutdown()
        srv.server_close()


def test_chain_ledgers_reach_identical_node_states():
    ours, our_reads = _replay(tchain)
    ref, ref_reads = _replay(jchain)
    assert ours == ref
    assert our_reads == ref_reads
    # and the in-process ledger settles the same sequence to the same numbers
    led = Ledger()
    led.mint("user", 10_000)
    led.mint("miner-0", 1_000)
    led.stake("miner-0", 1_000)
    led.deposit_and_commit("user", "r1", prompt_commitment("p"), 10_000)
    led.record_submission("validator", "r1", "miner-0", 0.8, b"\x00" * 32)
    led.distribute_rewards("validator", "r1")
    led.slash_stake("validator", "miner-0")
    assert our_reads["claimable_v"] == led.claim("validator") == 3_000
    assert ours["tao"][MINER] == led.claim("miner-0") == 7_000
    assert our_reads["stake"] == led.stake_of("miner-0") - 400 == 500
    assert our_reads["status"] == [3, 4] and our_reads["w"] == [0, 65535]
    assert our_reads["prompt"] == [True, False]
