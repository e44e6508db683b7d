"""Neuron framework: identities, the registry, scores and weights.

This package's own copy of ``dvdx_tpu/network/base.py``: the ``Registry``
(the shared neuron table, thread-safe, with each miner's platform pin),
``NeuronInfo``, the ``ScoreBook`` (EMA scores -> kappa-clipped, L1-normalised
weights and their u16 on-chain form) and ``Neuron`` (an Ed25519 identity
bound to a registry).
"""

from __future__ import annotations

import dataclasses
import json
import random
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..verify.proof import Keypair

U16_MAX = 65535


@dataclasses.dataclass
class NeuronInfo:
    uid: int
    pubkey: bytes
    address: str                  # transport address ("mock://name" or "host:port")
    role: str = "miner"           # miner | validator
    stake: int = 0                # micro-TAO
    trust: float = 1.0
    is_serving: bool = True
    last_seen: float = 0.0
    # backend pinned at registration ("tpu"/"cpu"/...). The validator trusts
    # ONLY this pin — never the per-response platform tag — when deciding
    # whether re-execution must be bitwise; an empty pin means bitwise is
    # demanded (secure default).
    platform: str = ""


class Registry:
    """Shared neuron table (the metagraph analog). Thread-safe."""

    def __init__(self):
        self._lock = threading.RLock()
        self.neurons: Dict[int, NeuronInfo] = {}
        self._next_uid = 0

    def register(self, pubkey: bytes, address: str, role: str = "miner",
                 stake: int = 0, platform: str = "") -> int:
        with self._lock:
            for n in self.neurons.values():
                if n.pubkey == pubkey:
                    n.address = address
                    n.role = role
                    n.stake = max(n.stake, stake)
                    n.is_serving = True
                    n.last_seen = time.time()
                    if platform:
                        n.platform = platform
                    return n.uid
            uid = self._next_uid
            self._next_uid += 1
            self.neurons[uid] = NeuronInfo(uid=uid, pubkey=pubkey, address=address,
                                           role=role, stake=stake,
                                           last_seen=time.time(),
                                           platform=platform)
            return uid

    def replace_all(self, snapshot: Dict[str, dict]):
        """Swap in a registry snapshot (``to_json``'s form) under the lock:
        a miner's sync loop does this while its handler threads read."""
        fresh: Dict[int, NeuronInfo] = {}
        for uid_str, n in snapshot.items():
            uid = int(uid_str)
            fresh[uid] = NeuronInfo(uid=uid, pubkey=bytes.fromhex(n["pubkey"]),
                                    address=n["address"], role=n["role"],
                                    stake=int(n["stake"]),
                                    trust=float(n.get("trust", 1.0)),
                                    is_serving=bool(n.get("serving", True)),
                                    last_seen=time.time(),
                                    platform=str(n.get("platform", "")))
        with self._lock:
            self.neurons = fresh
            self._next_uid = max(fresh, default=-1) + 1

    def get(self, uid: int) -> Optional[NeuronInfo]:
        return self.neurons.get(uid)

    def by_pubkey(self, pubkey: bytes) -> Optional[NeuronInfo]:
        with self._lock:
            for n in self.neurons.values():
                if n.pubkey == pubkey:
                    return n
        return None

    def miners(self) -> List[NeuronInfo]:
        with self._lock:
            return [n for n in self.neurons.values() if n.role == "miner"]

    def sample_miner_uids(self, k: int, rng: Optional[random.Random] = None,
                          min_stake: int = 0) -> List[int]:
        """Availability-filtered random sample (uids.py:21-48 analog)."""
        rng = rng or random.Random()
        with self._lock:
            avail = [n.uid for n in self.neurons.values()
                     if n.role == "miner" and n.is_serving and n.stake >= min_stake]
        rng.shuffle(avail)
        return sorted(avail[:k])

    def update_trust(self, uid: int, caught_cheating: bool, decay: float = 0.8,
                     honest_drift: float = 0.01):
        """Trust dynamics (reference validator.py:1222-1245 / economics gamma):
        caught -> trust *= (1 - decay) — gamma is the fraction REMOVED, so
        the reference's gamma=0.8 leaves 20% of trust (`self.trust_weights
        [hotkey] *= (1 - self.config.trust_decay)`); honest -> drift toward 1."""
        with self._lock:
            n = self.neurons.get(uid)
            if n is None:
                return
            if caught_cheating:
                n.trust *= (1.0 - decay)
            else:
                n.trust = min(1.0, n.trust + honest_drift)

    def to_json(self) -> str:
        with self._lock:
            return json.dumps({
                str(uid): {
                    "pubkey": n.pubkey.hex(), "address": n.address, "role": n.role,
                    "stake": n.stake, "trust": n.trust, "serving": n.is_serving,
                    "platform": n.platform,
                }
                for uid, n in self.neurons.items()
            }, indent=2)


# --- score vector + weight emission (base/validator.py + weight_utils.py) ---


class ScoreBook:
    """EMA miner scores -> kappa-clipped normalised u16 weights."""

    def __init__(self, alpha: float = 0.1, kappa_limit: float = 0.1):
        self.alpha = alpha          # EMA step (reference neuron.moving_average_alpha)
        self.kappa_limit = kappa_limit  # max normalised weight (weight_utils limit=0.1)
        self.scores: Dict[int, float] = {}

    def update(self, uid: int, reward: float):
        """EMA update (base/validator.py:353-414)."""
        prev = self.scores.get(uid, 0.0)
        self.scores[uid] = (1 - self.alpha) * prev + self.alpha * float(reward)

    def update_many(self, uids: List[int], rewards: List[float]):
        for u, r in zip(uids, rewards):
            self.update(u, r)

    def handle_hotkey_swap(self, uid: int):
        """A uid whose key was replaced starts again from 0."""
        self.scores[uid] = 0.0

    def weights(self) -> Dict[int, float]:
        """kappa-clip + L1 normalise (weight_utils.py:10-56): no single miner
        may exceed kappa_limit of total weight; iterate clip->renorm."""
        uids = sorted(self.scores)
        w = np.asarray([max(0.0, self.scores[u]) for u in uids], np.float64)
        if w.sum() <= 0:
            return {u: 0.0 for u in uids}
        w = w / w.sum()
        for _ in range(16):
            over = w > self.kappa_limit
            if not over.any() or over.all():
                break
            excess = (w[over] - self.kappa_limit).sum()
            w[over] = self.kappa_limit
            under = ~over
            if w[under].sum() > 0:
                w[under] += excess * w[under] / w[under].sum()
            else:
                break
        return {u: float(x) for u, x in zip(uids, w)}

    def weights_u16(self) -> Dict[int, int]:
        """On-chain u16 representation (weight_utils u16 conversion)."""
        w = self.weights()
        m = max(w.values(), default=0.0)
        if m <= 0:
            return {u: 0 for u in w}
        return {u: int(round(x / m * U16_MAX)) for u, x in w.items()}

    def save(self, path: str):
        """``uids`` and ``scores`` arrays in an npz, the JAX package's format,
        so a validator's state resumes in either package."""
        np.savez(path, uids=np.asarray(sorted(self.scores)),
                 scores=np.asarray([self.scores[u] for u in sorted(self.scores)]))

    def load(self, path: str):
        d = np.load(path)
        self.scores = {int(u): float(s) for u, s in zip(d["uids"], d["scores"])}


@dataclasses.dataclass
class Neuron:
    """Common identity bundle (BaseNeuron analog minus the chain)."""

    keypair: Keypair
    registry: Registry
    uid: int = -1
    role: str = "miner"

    @property
    def pubkey(self) -> bytes:
        return self.keypair.public_bytes

    def register(self, address: str, stake: int = 0, platform: str = ""):
        self.uid = self.registry.register(self.pubkey, address, self.role,
                                          stake, platform=platform)
        return self.uid
