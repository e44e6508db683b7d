"""Deposit event listener: ledger events -> the validator's work queue.

This package's own copy of ``dvdx_tpu/network/deposit_listener.py``. One
daemon thread polls the ledger's event log (``Ledger.events_from_index``, or
a chain adapter with the same interface) every ``poll_interval_s``, tracks
each deposit as ``active_requests[request_id] = {user, amount, prompt_hash,
status: pending, ...}`` and refunds requests left 'pending' longer than
``stuck_timeout_s``. Every state change happens under one lock, so claiming a
request for a round and the stuck-request refund exclude each other.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple

from .ledger import Ledger


class DepositListener:
    def __init__(self, ledger: Ledger, poll_interval_s: float = 2.0,
                 stuck_timeout_s: float = 600.0,
                 on_deposit: Optional[Callable[[str, dict], None]] = None):
        self.ledger = ledger
        self.poll_interval_s = poll_interval_s
        self.stuck_timeout_s = stuck_timeout_s
        self.on_deposit = on_deposit
        self._lock = threading.RLock()
        self.active_requests: Dict[str, dict] = {}
        self._next_event_idx = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.metrics = {"deposits_seen": 0, "auto_refunds": 0, "polls": 0}

    # -- lifecycle --

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="deposit-listener")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    # -- polling --

    def poll_once(self):
        """One poll cycle (tests call it synchronously)."""
        self.metrics["polls"] += 1
        events = self.ledger.events_from_index(self._next_event_idx)
        self._next_event_idx += len(events)
        with self._lock:
            for ev in events:
                if ev.kind == "Deposit":
                    rid = ev.data["request_id"]
                    if rid not in self.active_requests:
                        self.metrics["deposits_seen"] += 1
                        entry = {
                            "user": ev.data["user"],
                            "amount": ev.data["amount"],
                            "prompt_hash": ev.data["prompt_hash"],
                            "status": "pending",
                            "prompt": None,
                            "seen_at": time.time(),
                        }
                        self.active_requests[rid] = entry
                        if self.on_deposit:
                            self.on_deposit(rid, entry)
        self.ledger.advance_block()
        self._refund_stuck()

    def try_refund(self, request_id: str) -> bool:
        """Refund a request only while it is still 'pending' here, under the
        lock: a claimed round can no longer be refunded out from under its
        miners."""
        with self._lock:
            entry = self.active_requests.get(request_id)
            if entry is None or entry["status"] != "pending":
                return False
            self.ledger.refund_unused("validator", request_id)
            entry["status"] = "refunded"
            return True

    def _refund_stuck(self):
        now = time.time()
        with self._lock:
            stale = [rid for rid, e in self.active_requests.items()
                     if e["status"] == "pending"
                     and now - e["seen_at"] > self.stuck_timeout_s]
        for rid in stale:
            try:
                if self.try_refund(rid):
                    self.metrics["auto_refunds"] += 1
            except Exception:  # a ledger error leaves the request pending
                pass

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:  # the next poll retries
                pass
            self._stop.wait(self.poll_interval_s)

    # -- request state machine (pending -> processing -> completed/failed) --

    def attach_prompt(self, request_id: str, prompt: str) -> bool:
        """Store the cleartext prompt once it matches the ledger's
        commitment (the REST /submit_prompt path)."""
        if not self.ledger.verify_prompt(request_id, prompt):
            return False
        with self._lock:
            entry = self.active_requests.get(request_id)
            if entry is None:
                return False
            entry["prompt"] = prompt
        return True

    def next_ready(self) -> Optional[str]:
        """A pending request that has its prompt."""
        with self._lock:
            for rid, e in self.active_requests.items():
                if e["status"] == "pending" and e["prompt"]:
                    return rid
        return None

    def claim_next_ready(self) -> Optional[Tuple[str, str]]:
        """Claim a ready request: pending -> processing under the lock, and
        return (request_id, prompt). A refunded request can never be
        claimed, and a claimed one can never be refunded."""
        with self._lock:
            for rid, e in self.active_requests.items():
                if e["status"] == "pending" and e["prompt"]:
                    e["status"] = "processing"
                    return rid, e["prompt"]
        return None

    def set_status(self, request_id: str, status: str):
        with self._lock:
            if request_id in self.active_requests:
                self.active_requests[request_id]["status"] = status

    def status_of(self, request_id: str) -> Optional[dict]:
        with self._lock:
            e = self.active_requests.get(request_id)
            return dict(e) if e else None

    def all_requests(self) -> Dict[str, dict]:
        """Every tracked request for the live-rounds view, without the
        cleartext prompts (only whether one was revealed)."""
        with self._lock:
            return {
                rid: {
                    "status": e["status"],
                    "user": e["user"],
                    "amount": e["amount"],
                    "has_prompt": bool(e["prompt"]),
                    "seen_at": e["seen_at"],
                }
                for rid, e in self.active_requests.items()
            }
