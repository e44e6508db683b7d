"""Deterministic escrow / commit-reveal / reward ledger.

This package's own copy of ``dvdx_tpu/network/ledger.py``: a thread-safe,
chain-agnostic state machine with integer micro-TAO balances. A user
deposits and commits sha256(prompt); the validator (and only it) records
staked miners' scores, distributes the escrow (``miner_split`` pro rata to
score, the rest to the validator), slashes stakes, refunds stuck requests
and records the epoch's u16 weight vector. Every mutation appends an
``Event``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Dict, List, Optional

MICRO = 10**6  # 1 TAO = 1e6 micro


def prompt_commitment(prompt: str) -> bytes:
    return hashlib.sha256(prompt.encode("utf-8")).digest()


@dataclasses.dataclass
class Event:
    kind: str                 # Deposit | Submission | Reward | Refund | Slash | Stake
    block: int
    data: dict

    def to_dict(self):
        return {"kind": self.kind, "block": self.block, "data": self.data}


@dataclasses.dataclass
class Request:
    request_id: str
    user: str
    prompt_hash: bytes
    amount: int                     # escrowed micro-TAO
    status: str = "pending"         # pending | submitted | distributed | refunded
    created_block: int = 0
    submissions: Dict[str, dict] = dataclasses.field(default_factory=dict)


class LedgerError(Exception):
    pass


class Ledger:
    """In-process deterministic ledger. Thread-safe (the API server, deposit
    listener and validator loop all touch it — the reference mutates
    `active_requests` from three daemon threads with no lock,
    SURVEY.md §5 'race detection: none'; we do better)."""

    def __init__(self, validator_account: str = "validator",
                 miner_split: float = 0.7, slash_fraction: float = 0.1):
        self._lock = threading.RLock()
        self.block = 0
        self.balances: Dict[str, int] = {}
        self.stakes: Dict[str, int] = {}
        self.claimable: Dict[str, int] = {}
        self.requests: Dict[str, Request] = {}
        self.events: List[Event] = []
        self.validator_account = validator_account
        self.miner_split = miner_split          # reference s = 0.70 (config.py:64-79)
        self.slash_fraction = slash_fraction    # reference f* = 0.10
        # epoch-stamped miner weight vector (Sol setWeights twin): the one
        # chain-visible incentive artifact the reference validator emits each
        # epoch (`template/base/validator.py:187-291`, weight_utils.py u16)
        self.weights_epoch = 0
        self.weights: Dict[int, int] = {}

    # -- chain mechanics --

    def _emit(self, kind: str, **data):
        self.events.append(Event(kind, self.block, data))

    def advance_block(self, n: int = 1):
        with self._lock:
            self.block += n

    def events_since(self, block: int) -> List[Event]:
        with self._lock:
            return [e for e in self.events if e.block >= block]

    def events_from_index(self, index: int) -> List[Event]:
        """Events appended at or after list position ``index``. The log only
        grows, so a consumer reading by index never skips an event (a block
        watermark would race with emits in the same block)."""
        with self._lock:
            return list(self.events[index:])

    # -- balances / stake --

    def mint(self, account: str, amount: int):
        with self._lock:
            self.balances[account] = self.balances.get(account, 0) + int(amount)

    def balance(self, account: str) -> int:
        return self.balances.get(account, 0)

    def burn(self, account: str, amount: int):
        """Remove funds (the REST faucet rolls its mint back with this)."""
        with self._lock:
            if self.balances.get(account, 0) < amount:
                raise LedgerError("insufficient balance to burn")
            self.balances[account] -= int(amount)

    def stake(self, account: str, amount: int):
        with self._lock:
            amount = int(amount)
            if self.balances.get(account, 0) < amount:
                raise LedgerError("insufficient balance to stake")
            self.balances[account] -= amount
            self.stakes[account] = self.stakes.get(account, 0) + amount
            self._emit("Stake", account=account, amount=amount)

    def stake_of(self, account: str) -> int:
        return self.stakes.get(account, 0)

    def slash_stake(self, caller: str, miner: str, fraction: Optional[float] = None) -> int:
        """Burn a fraction of the miner's stake (Sol slashStake; validator-only)."""
        with self._lock:
            if caller != self.validator_account:
                raise LedgerError("only validator can slash")
            frac = self.slash_fraction if fraction is None else fraction
            s = self.stakes.get(miner, 0)
            cut = int(s * frac)
            self.stakes[miner] = s - cut
            self._emit("Slash", miner=miner, amount=cut, fraction=frac)
            return cut

    def set_weights(self, caller: str, uids: List[int], weights: List[int]) -> int:
        """Record the validator's per-epoch u16 weight vector (Sol setWeights;
        validator-only, sorted uids, wholesale replacement). Returns the new
        epoch number."""
        with self._lock:
            if caller != self.validator_account:
                raise LedgerError("only validator can set weights")
            if len(uids) != len(weights):
                raise LedgerError("length mismatch")
            if not uids:
                raise LedgerError("empty weights")
            if any(b <= a for a, b in zip(uids, uids[1:])):
                raise LedgerError("uids not sorted")
            for u, w in zip(uids, weights):
                if not (0 <= int(w) <= 0xFFFF and 0 <= int(u) <= 0xFFFF):
                    raise LedgerError("uid/weight out of u16 range")
            self.weights = {int(u): int(w) for u, w in zip(uids, weights)}
            self.weights_epoch += 1
            self._emit("Weights", epoch=self.weights_epoch,
                       uids=[int(u) for u in uids],
                       weights=[int(w) for w in weights])
            return self.weights_epoch

    def weight_of(self, uid: int) -> int:
        with self._lock:
            return self.weights.get(int(uid), 0)

    # -- request lifecycle --

    def deposit_and_commit(self, user: str, request_id: str, prompt_hash: bytes,
                           amount: int):
        """Escrow user funds + commit the prompt hash (Sol depositAndCommit)."""
        with self._lock:
            amount = int(amount)
            if request_id in self.requests:
                raise LedgerError("request exists")
            if self.balances.get(user, 0) < amount:
                raise LedgerError("insufficient balance")
            if amount <= 0:
                raise LedgerError("zero deposit")
            self.balances[user] -= amount
            self.requests[request_id] = Request(
                request_id=request_id, user=user, prompt_hash=bytes(prompt_hash),
                amount=amount, created_block=self.block,
            )
            self._emit("Deposit", user=user, request_id=request_id,
                       amount=amount, prompt_hash=prompt_hash.hex())

    def verify_prompt(self, request_id: str, prompt: str) -> bool:
        """keccak(prompt)==promptHash check analog (validator.py:1084-1101)."""
        with self._lock:
            req = self.requests.get(request_id)
            return bool(req) and prompt_commitment(prompt) == req.prompt_hash

    def record_submission(self, caller: str, request_id: str, miner: str,
                          score: float, proof_bytes: bytes):
        """Sol recordSubmission: onlyValidator, miner must be staked, stores
        (score, proof) for reward distribution."""
        with self._lock:
            if caller != self.validator_account:
                raise LedgerError("only validator can record")
            req = self.requests.get(request_id)
            if req is None:
                raise LedgerError("unknown request")
            if req.status not in ("pending", "submitted"):
                raise LedgerError(f"request {req.status}")
            if self.stakes.get(miner, 0) <= 0:
                raise LedgerError("miner not staked")
            req.submissions[miner] = {
                "score": float(score),
                "proof": bytes(proof_bytes),
                "block": self.block,
            }
            req.status = "submitted"
            self._emit("Submission", request_id=request_id, miner=miner, score=score)

    def distribute_rewards(self, caller: str, request_id: str):
        """Split the escrow: miner_split pro-rata to score; remainder to the
        validator (Sol distributeRewards)."""
        with self._lock:
            if caller != self.validator_account:
                raise LedgerError("only validator can distribute")
            req = self.requests.get(request_id)
            if req is None or req.status != "submitted":
                raise LedgerError("nothing to distribute")
            total_score = sum(s["score"] for s in req.submissions.values())
            miner_pool = int(req.amount * self.miner_split)
            paid = 0
            if total_score > 0:
                for miner, sub in sorted(req.submissions.items()):
                    share = int(miner_pool * sub["score"] / total_score)
                    self.claimable[miner] = self.claimable.get(miner, 0) + share
                    paid += share
            val_cut = req.amount - paid
            self.claimable[self.validator_account] = (
                self.claimable.get(self.validator_account, 0) + val_cut
            )
            req.status = "distributed"
            self._emit("Reward", request_id=request_id, miner_pool=miner_pool,
                       validator_cut=val_cut)

    def claim(self, account: str) -> int:
        with self._lock:
            amt = self.claimable.pop(account, 0)
            self.balances[account] = self.balances.get(account, 0) + amt
            return amt

    def refund_unused(self, caller: str, request_id: str):
        """Refund escrow of a stuck pending request (Sol refundUnused; driven
        by the deposit listener after timeout, deposit_listener.py:113-155)."""
        with self._lock:
            if caller != self.validator_account:
                raise LedgerError("only validator can refund")
            req = self.requests.get(request_id)
            if req is None or req.status != "pending":
                raise LedgerError("not refundable")
            self.balances[req.user] = self.balances.get(req.user, 0) + req.amount
            req.status = "refunded"
            self._emit("Refund", request_id=request_id, amount=req.amount)

    # -- snapshots --

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "block": self.block,
                "balances": dict(self.balances),
                "stakes": dict(self.stakes),
                "claimable": dict(self.claimable),
                "weights_epoch": self.weights_epoch,
                "weights": dict(self.weights),
                "requests": {
                    k: {
                        "user": r.user, "amount": r.amount, "status": r.status,
                        "prompt_hash": r.prompt_hash.hex(),
                        "submissions": {
                            m: {"score": s["score"], "block": s["block"]}
                            for m, s in r.submissions.items()
                        },
                    }
                    for k, r in self.requests.items()
                },
            }
