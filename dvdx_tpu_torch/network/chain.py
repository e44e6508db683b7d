"""ChainLedger: the Ledger interface over Ethereum JSON-RPC.

This package's own copy of ``dvdx_tpu/network/chain.py``: the same calldata
for the same calls. It drives a deployed ``evm/DVDXRewards.sol`` with no
heavyweight dependency: raw JSON-RPC over HTTP (urllib), ABI encoding built
on the package's own ``utils.keccak``, and ``eth_sendTransaction`` from an
unlocked dev account (the anvil / hardhat / geth-dev model; a production
deployment puts a signer in front).

It implements the calls the validator makes on ``network.ledger.Ledger``
(record_submission / distribute_rewards / slash_stake / set_weights /
deposit_and_commit / stake / refund_unused / claim / stake_of /
verify_prompt), so ``Validator(..., ledger=ChainLedger(...))`` settles rounds
on chain.

Accounts: the in-process ledger keys accounts by name ("miner-0"); the chain
needs addresses, so pass ``accounts={"miner-0": "0x...", ...}``. An unknown
account raises ``LedgerError``.
"""

from __future__ import annotations

import hashlib
import json
import time
import urllib.request
from typing import Dict, List, Optional, Sequence

from ..utils.keccak import keccak256, selector
from .ledger import LedgerError

ZERO32 = b"\x00" * 32


# --- ABI encoding (static types only — all DVDXRewards entrypoints are) -------


def enc_uint(v: int) -> bytes:
    if v < 0 or v >= 1 << 256:
        raise ValueError("uint out of range")
    return int(v).to_bytes(32, "big")


def enc_address(addr: str) -> bytes:
    h = addr.lower().removeprefix("0x")
    if len(h) != 40:
        raise ValueError(f"bad address {addr!r}")
    return b"\x00" * 12 + bytes.fromhex(h)


def enc_bytes32(b: bytes) -> bytes:
    if len(b) != 32:
        raise ValueError("need exactly 32 bytes")
    return b


def enc_uint_array(vals: Sequence[int]) -> bytes:
    """Tail encoding of a dynamic uint array: length word + one padded word
    per element (every uintN element occupies a full 32-byte word in ABI)."""
    out = bytearray(enc_uint(len(vals)))
    for v in vals:
        out += enc_uint(int(v))
    return bytes(out)


def encode_call(signature: str, args: Sequence) -> bytes:
    """selector(signature) ‖ ABI-encoded args (static head + dynamic tails —
    dynamic support covers the uintN[] arrays setWeights takes)."""
    types = signature[signature.index("(") + 1 : -1]
    type_list = [t for t in types.split(",") if t]
    if len(type_list) != len(args):
        raise ValueError("arity mismatch")
    head = []
    tails: List[bytes] = []
    for t, a in zip(type_list, args):
        if t.endswith("[]"):
            if not t.startswith("uint"):
                raise ValueError(f"unsupported dynamic type {t}")
            head.append(None)                 # placeholder for the offset
            tails.append(enc_uint_array(a))
        elif t.startswith("uint"):
            head.append(enc_uint(int(a)))
        elif t == "address":
            head.append(enc_address(a))
        elif t == "bytes32":
            head.append(enc_bytes32(a))
        else:
            raise ValueError(f"unsupported static type {t}")
    out = bytearray(selector(signature))
    offset = 32 * len(head)
    tail_iter = iter(tails)
    tail_bytes = bytearray()
    for h in head:
        if h is None:
            tail = next(tail_iter)
            out += enc_uint(offset + len(tail_bytes))
            tail_bytes += tail
        else:
            out += h
    out += tail_bytes
    return bytes(out)


def request_id_to_bytes32(request_id: str) -> bytes:
    """Deterministic opaque bytes32 for a string request id (the frontend
    does the same client-side)."""
    return keccak256(request_id.encode())


class JsonRpc:
    """Minimal JSON-RPC 2.0 client over HTTP."""

    def __init__(self, url: str, timeout_s: float = 10.0):
        self.url = url
        self.timeout_s = timeout_s
        self._id = 0

    def call(self, method: str, params: list):
        self._id += 1
        body = json.dumps({"jsonrpc": "2.0", "id": self._id,
                           "method": method, "params": params}).encode()
        req = urllib.request.Request(
            self.url, data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            reply = json.loads(r.read())
        if "error" in reply:
            raise LedgerError(f"rpc {method}: {reply['error']}")
        return reply.get("result")


class ChainLedger:
    """Ledger-compatible adapter over a deployed DVDXRewards contract."""

    def __init__(self, rpc_url: str, contract: str, *,
                 validator_address: str,
                 accounts: Optional[Dict[str, str]] = None,
                 wait_receipts: bool = True,
                 receipt_timeout_s: float = 30.0):
        self.rpc = JsonRpc(rpc_url)
        self.contract = contract
        self.validator_address = validator_address
        self.accounts = dict(accounts or {})
        self.wait_receipts = wait_receipts
        self.receipt_timeout_s = receipt_timeout_s
        # mirrors ledger.Ledger's prompt commitments for verify_prompt
        self._commitments: Dict[str, bytes] = {}

    # -- plumbing -----------------------------------------------------------

    def _addr(self, account: str) -> str:
        if account.startswith("0x") and len(account) == 42:
            return account
        if account == "validator":
            return self.validator_address
        if account not in self.accounts:
            raise LedgerError(f"no chain address for account {account!r}")
        return self.accounts[account]

    def _send(self, from_addr: str, data: bytes) -> str:
        txh = self.rpc.call("eth_sendTransaction", [{
            "from": from_addr,
            "to": self.contract,
            "gas": hex(1_000_000),
            "data": "0x" + data.hex(),
        }])
        if self.wait_receipts:
            self._wait(txh)
        return txh

    def _wait(self, txh: str):
        deadline = time.time() + self.receipt_timeout_s
        while time.time() < deadline:
            rec = self.rpc.call("eth_getTransactionReceipt", [txh])
            if rec is not None:
                if int(rec.get("status", "0x1"), 16) != 1:
                    raise LedgerError(f"tx {txh} reverted")
                return rec
            time.sleep(0.25)
        raise LedgerError(f"tx {txh} timed out")

    def _call(self, data: bytes) -> bytes:
        result = self.rpc.call("eth_call", [{"to": self.contract,
                                             "data": "0x" + data.hex()},
                                            "latest"])
        return bytes.fromhex((result or "0x").removeprefix("0x"))

    # -- Ledger interface (the calls network/validator.py makes) -------------

    def deposit_and_commit(self, user: str, request_id: str,
                           commitment: bytes, amount: int) -> str:
        self._commitments[request_id] = commitment
        return self._send(self._addr(user), encode_call(
            "depositAndCommit(bytes32,bytes32,uint256)",
            [request_id_to_bytes32(request_id), commitment, amount]))

    def stake(self, account: str, amount: int) -> str:
        return self._send(self._addr(account),
                          encode_call("stake(uint256)", [amount]))

    def record_submission(self, caller: str, request_id: str, account: str,
                          score: float, proof_bytes: bytes) -> str:
        """proof_bytes = merkle_root(32) ‖ signature — the root anchors the
        off-chain Proof-of-Inference (validator.py detail assembly)."""
        root = proof_bytes[:32] if len(proof_bytes) >= 32 else ZERO32
        return self._send(self._addr(caller), encode_call(
            "recordSubmission(bytes32,address,uint32,bytes32)",
            [request_id_to_bytes32(request_id), self._addr(account),
             int(round(score * 1000)), root]))

    def distribute_rewards(self, caller: str, request_id: str) -> str:
        return self._send(self._addr(caller), encode_call(
            "distributeRewards(bytes32)", [request_id_to_bytes32(request_id)]))

    def slash_stake(self, caller: str, account: str,
                    fraction: float = 0.1) -> str:
        # fraction is fixed on-chain (SLASH_BPS); the argument is accepted
        # for Ledger-interface compatibility
        return self._send(self._addr(caller), encode_call(
            "slashStake(address)", [self._addr(account)]))

    def refund_unused(self, caller: str, request_id: str) -> str:
        return self._send(self._addr(caller), encode_call(
            "refundUnused(bytes32)", [request_id_to_bytes32(request_id)]))

    def claim(self, account: str) -> str:
        return self._send(self._addr(account), encode_call("claimReward()", []))

    def set_weights(self, caller: str, uids: Sequence[int],
                    weights: Sequence[int]) -> str:
        """Record the per-epoch u16 weight vector on-chain (Sol setWeights;
        same signature as Ledger.set_weights so the validator's emission path
        is ledger-implementation-agnostic)."""
        return self._send(self._addr(caller), encode_call(
            "setWeights(uint16[],uint16[])", [list(uids), list(weights)]))

    def request_unstake(self, account: str, amount: int) -> str:
        return self._send(self._addr(account), encode_call(
            "requestUnstake(uint256)", [amount]))

    def withdraw_stake(self, account: str) -> str:
        return self._send(self._addr(account),
                          encode_call("withdrawStake()", []))

    # -- reads ----------------------------------------------------------------

    def stake_of(self, account: str) -> int:
        out = self._call(encode_call("stakes(address)", [self._addr(account)]))
        return int.from_bytes(out[:32], "big") if out else 0

    def claimable_of(self, account: str) -> int:
        out = self._call(encode_call("claimable(address)",
                                     [self._addr(account)]))
        return int.from_bytes(out[:32], "big") if out else 0

    def request_status(self, request_id: str) -> int:
        out = self._call(encode_call("requests(bytes32)",
                                     [request_id_to_bytes32(request_id)]))
        # (user, promptHash, amount, createdAt, status) — status is word 4
        return int.from_bytes(out[128:160], "big") if len(out) >= 160 else 0

    def weights_epoch(self) -> int:
        out = self._call(encode_call("weightsEpoch()", []))
        return int.from_bytes(out[:32], "big") if out else 0

    def weight_of(self, uid: int) -> int:
        out = self._call(encode_call("weightOf(uint16)", [int(uid)]))
        return int.from_bytes(out[:32], "big") if out else 0

    def weight_uid_count(self) -> int:
        out = self._call(encode_call("weightUidCount()", []))
        return int.from_bytes(out[:32], "big") if out else 0

    def verify_prompt(self, request_id: str, prompt: str) -> bool:
        """Commitment check against the on-chain promptHash: sha256 (as
        ledger.prompt_commitment) or keccak256 of the prompt."""
        out = self._call(encode_call("requests(bytes32)",
                                     [request_id_to_bytes32(request_id)]))
        if len(out) < 64:
            return False
        onchain = out[32:64]
        return onchain in (hashlib.sha256(prompt.encode()).digest(),
                           keccak256(prompt.encode()))

    def mint(self, account: str, amount: int):  # dev-faucet parity no-op
        raise LedgerError("mint is an in-process dev-faucet; fund the ERC-20 "
                          "account on-chain instead")
