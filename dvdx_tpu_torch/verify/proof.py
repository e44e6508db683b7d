"""Proof-of-Inference primitives: seed derivation, signatures, spot-check
sampling.

This package's own copy of ``dvdx_tpu/verify/proof.py``, byte-compatible
with it, so a miner of either package is verified by a validator of the
other:

* ``derive_seed``: the first 8 bytes of HMAC-SHA256(validator key,
  challenge), little-endian;
* the signed proof message challenge || seed_le64 || sha256(video) ||
  merkle_root;
* Ed25519 signatures (the ``cryptography`` package, which both hosts carry);
* the length-prefixed registration message with its replay bound;
* commit-then-reveal spot-check indices (and their consecutive pairs),
  drawn from a post-commit audit secret so the miner cannot grind its fake
  leaves against them;
* ``InferenceProof``, the proof dict a miner returns.
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
import time
from typing import List, Optional, Tuple

from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives.asymmetric.ed25519 import (Ed25519PrivateKey,
                                                               Ed25519PublicKey)
from cryptography.hazmat.primitives.serialization import Encoding, PublicFormat


def derive_seed(validator_key: bytes, challenge: bytes) -> int:
    """64-bit inference seed: HMAC-SHA256(key, challenge)[:8], little-endian."""
    digest = hmac.new(validator_key, challenge, hashlib.sha256).digest()
    return int.from_bytes(digest[:8], "little")


@dataclasses.dataclass(frozen=True)
class Keypair:
    """Ed25519 signing identity of a miner or validator."""

    private: Ed25519PrivateKey

    @classmethod
    def generate(cls) -> "Keypair":
        return cls(Ed25519PrivateKey.generate())

    @classmethod
    def from_seed(cls, seed: bytes) -> "Keypair":
        """Deterministic keypair: the private key is sha256(seed)."""
        return cls(Ed25519PrivateKey.from_private_bytes(hashlib.sha256(seed).digest()))

    @property
    def public_bytes(self) -> bytes:
        return self.private.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw)

    def sign(self, message: bytes) -> bytes:
        return self.private.sign(message)


def verify_signature(public_bytes: bytes, message: bytes, signature: bytes) -> bool:
    try:
        Ed25519PublicKey.from_public_bytes(public_bytes).verify(signature, message)
        return True
    except (InvalidSignature, ValueError):
        return False


def proof_message(challenge: bytes, seed: int, video_sha256: bytes,
                  merkle_root: bytes) -> bytes:
    """challenge || seed_le64 || sha256(video) || root: what a miner signs."""
    return challenge + int(seed).to_bytes(8, "little") + video_sha256 + merkle_root


def sign_proof(keypair: Keypair, challenge: bytes, seed: int, video_bytes: bytes,
               merkle_root: bytes) -> bytes:
    return keypair.sign(proof_message(challenge, seed,
                                      hashlib.sha256(video_bytes).digest(), merkle_root))


def verify_proof_signature(public_bytes: bytes, challenge: bytes, seed: int,
                           video_bytes: bytes, merkle_root: bytes,
                           signature: bytes) -> bool:
    msg = proof_message(challenge, seed, hashlib.sha256(video_bytes).digest(), merkle_root)
    return verify_signature(public_bytes, msg, signature)


# how far a registration's signed timestamp may be from the verifier's clock
REGISTRATION_MAX_AGE_S = 600


def registration_message(pubkey: bytes, address: str, role: str, platform: str,
                         stake: int, timestamp: int) -> bytes:
    """The bytes a neuron signs to register: length-prefixed fields (no
    separator injection), the stake and the timestamp, so the platform pin
    is bound to the key's owner and a captured registration replays only
    within REGISTRATION_MAX_AGE_S."""
    def lp(b: bytes) -> bytes:
        return len(b).to_bytes(2, "big") + b

    return (b"dvdx-register-v2" + lp(pubkey) + lp(address.encode())
            + lp(role.encode()) + lp(platform.encode())
            + int(stake).to_bytes(8, "big") + int(timestamp).to_bytes(8, "big"))


def sign_registration(keypair: Keypair, address: str, role: str, platform: str,
                      stake: int = 0, timestamp: Optional[int] = None) -> Tuple[bytes, int]:
    """-> (signature, timestamp); the timestamp travels with the signature."""
    ts = int(time.time()) if timestamp is None else int(timestamp)
    return keypair.sign(registration_message(keypair.public_bytes, address, role,
                                             platform, stake, ts)), ts


def verify_registration_signature(public_bytes: bytes, address: str, role: str,
                                  platform: str, stake: int, timestamp: int,
                                  signature: bytes, *,
                                  now: Optional[float] = None) -> bool:
    """Signature valid and fresh (|now - timestamp| <= REGISTRATION_MAX_AGE_S)."""
    t = time.time() if now is None else now
    if abs(t - int(timestamp)) > REGISTRATION_MAX_AGE_S:
        return False
    return verify_signature(public_bytes, registration_message(
        public_bytes, address, role, platform, stake, timestamp), signature)


def sample_distinct_indices(domain: bytes, material: bytes, population: int,
                            k: int) -> List[int]:
    """k distinct indices in [0, population) from sha256(material || domain
    || counter), sorted: the rejection-sampling loop of the spot-check and
    video-binding samplers."""
    k = min(k, population)
    picked: List[int] = []
    counter = 0
    while len(picked) < k:
        digest = hashlib.sha256(material + domain + counter.to_bytes(4, "big")).digest()
        idx = int.from_bytes(digest[:8], "big") % population
        if idx not in picked:
            picked.append(idx)
        counter += 1
    return sorted(picked)


def sample_spotcheck_indices(merkle_root: bytes, challenge: bytes, num_steps: int,
                             num_checks: int = 3, *, secret: bytes) -> List[int]:
    """``num_checks`` distinct step indices in [0, num_steps), from the
    post-commit audit ``secret`` mixed with the root and the challenge. Root
    and challenge are known to the miner when it commits, so without the
    secret the sample could be ground; the secret is required."""
    if not secret:
        raise ValueError("sample_spotcheck_indices requires the post-commit "
                         "audit secret; commit-time-known inputs alone are "
                         "grindable by the miner")
    if num_steps < 1:
        return []
    return sample_distinct_indices(b"", secret + merkle_root + challenge,
                                   num_steps, num_checks)


def sample_spotcheck_pairs(merkle_root: bytes, challenge: bytes, num_steps: int,
                           secret: bytes, num_checks: int = 3) -> List[Tuple[int, int]]:
    """(i, min(i + 1, T - 1)) pairs of ``sample_spotcheck_indices``: step i
    is re-executed and z_{i+1} re-derived from it. ``secret`` is required,
    as there."""
    if not secret:
        raise ValueError("sample_spotcheck_pairs requires the post-commit "
                         "audit secret; commit-time-known inputs alone are "
                         "grindable by the miner")
    idxs = sample_spotcheck_indices(merkle_root, challenge, num_steps, num_checks,
                                    secret=secret)
    return [(i, i + 1) if i + 1 < num_steps else (i, i) for i in idxs]


@dataclasses.dataclass
class InferenceProof:
    """The proof a miner returns with a response, as a JSON-able dict of
    hex strings and ints (the reference's schema)."""

    merkle_root: bytes
    signature: bytes
    miner_pubkey: bytes
    challenge: bytes
    seed: int
    num_steps: int
    timesteps: List[int]
    video_sha256: bytes

    def to_dict(self) -> dict:
        return {"merkle_root": self.merkle_root.hex(), "signature": self.signature.hex(),
                "miner_pubkey": self.miner_pubkey.hex(), "challenge": self.challenge.hex(),
                "seed": self.seed, "num_steps": self.num_steps,
                "timesteps": [int(t) for t in self.timesteps],
                "video_sha256": self.video_sha256.hex()}

    @classmethod
    def from_dict(cls, d: dict) -> "InferenceProof":
        return cls(merkle_root=bytes.fromhex(d["merkle_root"]),
                   signature=bytes.fromhex(d["signature"]),
                   miner_pubkey=bytes.fromhex(d["miner_pubkey"]),
                   challenge=bytes.fromhex(d["challenge"]), seed=int(d["seed"]),
                   num_steps=int(d["num_steps"]),
                   timesteps=[int(t) for t in d["timesteps"]],
                   video_sha256=bytes.fromhex(d["video_sha256"]))
