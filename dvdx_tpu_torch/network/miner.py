"""Miner neuron: generate a video with its Proof of Inference on request.

Counterpart of ``dvdx_tpu/network/miner.py``, built over the port's
``verify.spotcheck.StepEngine``: on a signed, fresh ``InferenceRequest`` the
miner runs the recorded generation (the step program a validator
re-executes), commits the (z_t, eps_t) leaves to a Merkle tree, encodes the
video and signs challenge || seed || sha256(video) || root. A signed
``RevealRequest`` is answered with the leaves' little-endian bfloat16 bytes
and their Merkle paths. Callers are gated by signature, freshness, replay
and the blacklist; the in-memory proof store is an LRU, optionally backed by
a disk spool that keeps the leaves as uint16 views.

With ``mesh`` and ``strategy`` the miner generates through that strategy's
step program (``StepEngine(pipeline, mesh=, strategy=)``): it pins
"torch-<device>:<strategy>" at registration, and a chunked miner commits its
chunk count in the response. On a mesh of several ranks this miner is rank
0; the other ranks run ``miner.engine.follow()``.
"""

from __future__ import annotations

import collections
import dataclasses
import glob
import hashlib
import os
import re
import time
from typing import Optional

import numpy as np
import torch

from ..pipelines.text2video import Pipeline
from ..utils.profiling import span
from ..utils.video_io import encode_mp4
from ..verify.merkle import MerkleCommitment
from ..verify.proof import Keypair, sign_proof, verify_signature
from ..verify.spotcheck import StepEngine
from . import protocol as P
from .base import Neuron, Registry


@dataclasses.dataclass
class MinerConfig:
    max_stored_proofs: int = 16       # in-memory LRU of reveal-able traces
    spool_dir: str = ""               # optional disk spool behind the LRU
    max_spooled_proofs: int = 256
    min_validator_stake: int = 0      # blacklist threshold
    max_frames: int = 64
    max_steps: int = 100
    max_height: int = 1024
    max_width: int = 1600
    max_reveal_indices: int = 64      # after dedup; a validator asks for <= 2k + 2
    fps_default: int = 8
    max_request_age_s: float = 600.0  # replay bound on issued_at


class Miner(Neuron):
    """In-process miner logic; a transport calls ``handle``."""

    def __init__(self, pipeline: Pipeline, keypair: Keypair, registry: Registry,
                 config: Optional[MinerConfig] = None, *, mesh=None, strategy=None):
        super().__init__(keypair=keypair, registry=registry, role="miner")
        self.pipeline = pipeline
        self.engine = StepEngine(pipeline, mesh=mesh, strategy=strategy)
        self.config = config or MinerConfig()
        self._proofs: "collections.OrderedDict[str, MerkleCommitment]" = (
            collections.OrderedDict())
        self.metrics = {"requests": 0, "errors": 0, "reveals": 0, "total_gen_s": 0.0}
        # request_ids already served (replay dedupe within the freshness window)
        self._served_ids: "collections.OrderedDict[str, bool]" = collections.OrderedDict()

    @property
    def platform_tag(self) -> str:
        """Registration pin and response tag ("torch-cuda" / "torch-cpu",
        with ":<strategy>" for a strategy engine)."""
        return self.engine.platform_tag

    # -- policies --

    def blacklisted(self, validator_pubkey: bytes) -> bool:
        if not validator_pubkey:
            return True
        info = self.registry.by_pubkey(validator_pubkey)
        if info is None or info.role != "validator":
            return True
        return info.stake < self.config.min_validator_stake

    def priority(self, validator_pubkey: bytes) -> float:
        """A caller's priority: its registered stake (0 if unknown)."""
        info = self.registry.by_pubkey(validator_pubkey)
        return float(info.stake) if info else 0.0

    # -- request handling --

    def handle(self, msg):
        if isinstance(msg, P.Ping):
            return P.Pong(nonce=msg.nonce, pubkey=self.pubkey)
        if isinstance(msg, P.InferenceRequest):
            return self.handle_inference(msg)
        if isinstance(msg, P.RevealRequest):
            return self.handle_reveal(msg)
        raise ValueError(f"miner cannot handle {type(msg).__name__}")

    def _caller_rejected(self, req) -> str:
        """Gate of inference and reveal alike: a valid Ed25519 signature
        under the claimed validator key, a fresh issued_at, and a caller the
        blacklist lets through. Returns the refusal, or ""."""
        if not req.signature or not verify_signature(
                req.validator_pubkey, P.signing_bytes(req), req.signature):
            return "unsigned or invalid request signature"
        age = abs(time.time() - float(getattr(req, "issued_at", 0.0)))
        if age > self.config.max_request_age_s:
            return f"stale request (age {age:.0f}s > replay bound)"
        if self.blacklisted(req.validator_pubkey):
            return "blacklisted caller"
        return ""

    def handle_inference(self, req: P.InferenceRequest) -> P.InferenceResponse:
        self.metrics["requests"] += 1
        with span("miner.request"):
            with span("miner.verify_request"):
                rejected = self._caller_rejected(req)
                if not rejected and req.request_id in self._served_ids:
                    rejected = "replayed request_id"
            if rejected:
                self.metrics["errors"] += 1
                return P.InferenceResponse(request_id=req.request_id, status="error",
                                           error=rejected)
            self._served_ids[req.request_id] = True
            while len(self._served_ids) > 4096:
                self._served_ids.popitem(last=False)
            try:
                return self._generate_with_proof(req)
            except Exception as e:  # an error reply, not a dead miner
                self.metrics["errors"] += 1
                return P.InferenceResponse(request_id=req.request_id, status="error",
                                           error=f"{type(e).__name__}: {e}",
                                           miner_pubkey=self.pubkey,
                                           challenge=req.challenge, seed=req.seed)

    def _generate_with_proof(self, req: P.InferenceRequest) -> P.InferenceResponse:
        cfg = self.config
        if (req.num_frames > cfg.max_frames or req.num_steps > cfg.max_steps
                or req.height > cfg.max_height or req.width > cfg.max_width):
            raise ValueError("request exceeds miner limits")

        timings: dict = {}
        gen_phases: dict = {}
        with span("generate", timings) as gen:
            video, zs, epss, timesteps = self.engine.generate_recorded(
                req.prompt, negative_prompt=req.negative_prompt, seed=req.seed,
                num_frames=req.num_frames, height=req.height, width=req.width,
                num_steps=req.num_steps, guidance_scale=req.guidance_scale,
                cfg_split=req.cfg_split, timings=gen_phases)
        self.metrics["total_gen_s"] += gen.seconds
        timings.update({f"gen_{k}": v for k, v in gen_phases.items()})

        with span("merkle_commit", timings):
            commitment = MerkleCommitment(timesteps, zs, epss)
            self._store_proof(req.request_id, commitment)

        with span("encode_mp4", timings):
            mp4 = encode_mp4(video, fps=req.fps or cfg.fps_default)
        with span("sign_proof"):
            signature = sign_proof(self.keypair, req.challenge, req.seed, mp4,
                                   commitment.root)

        return P.InferenceResponse(
            request_id=req.request_id, video=mp4,
            video_sha256=hashlib.sha256(mp4).digest(),
            merkle_root=commitment.root, signature=signature,
            miner_pubkey=self.pubkey, challenge=req.challenge, seed=req.seed,
            num_steps=req.num_steps, timesteps=[int(t) for t in timesteps],
            latent_shape=[int(s) for s in zs.shape[1:]],
            latent_dtype=str(zs.dtype).removeprefix("torch."),
            num_chunks=(self.engine.chunk_plan(req.num_frames).num_chunks
                        if self.engine.chunked else 0),
            platform=self.platform_tag, gen_time_s=gen.seconds, timings=timings)

    # -- the proof store --

    def _spool_path(self, request_id: str) -> Optional[str]:
        if not self.config.spool_dir:
            return None
        safe = re.sub(r"[^A-Za-z0-9_.-]", "_", request_id)
        return os.path.join(self.config.spool_dir, f"trace_{safe}.npz")

    def _store_proof(self, request_id: str, commitment: MerkleCommitment):
        self._proofs[request_id] = commitment
        while len(self._proofs) > self.config.max_stored_proofs:
            self._proofs.popitem(last=False)
        path = self._spool_path(request_id)
        if path:
            with span("proof_spool"):
                os.makedirs(self.config.spool_dir, exist_ok=True)
                np.savez(path, timesteps=commitment.timesteps,
                         zs=_u16(commitment.zs), epss=_u16(commitment.epss),
                         dtype="bfloat16")
                self._prune_spool()

    def _prune_spool(self):
        files = sorted(glob.glob(os.path.join(self.config.spool_dir, "trace_*.npz")),
                       key=os.path.getmtime)
        for f in files[: max(0, len(files) - self.config.max_spooled_proofs)]:
            os.unlink(f)

    def _load_proof(self, request_id: str) -> Optional[MerkleCommitment]:
        com = self._proofs.get(request_id)
        if com is not None:
            return com
        path = self._spool_path(request_id)
        if path and os.path.exists(path):
            with np.load(path, allow_pickle=False) as d:
                if str(d["dtype"]) != "bfloat16":
                    raise ValueError(f"spooled trace of dtype {d['dtype']}")
                com = MerkleCommitment(d["timesteps"], _bf16(d["zs"]), _bf16(d["epss"]))
            self._proofs[request_id] = com  # warm the LRU, within its cap
            while len(self._proofs) > self.config.max_stored_proofs:
                self._proofs.popitem(last=False)
            return com
        return None

    def handle_reveal(self, req: P.RevealRequest) -> P.RevealResponse:
        self.metrics["reveals"] += 1
        with span("miner.reveal"):
            rejected = self._caller_rejected(req)
            if rejected:
                self.metrics["errors"] += 1
                return P.RevealResponse(request_id=req.request_id, status="error",
                                        error=rejected)
            with span("proof_load"):
                com = self._load_proof(req.request_id)
            if com is None:
                return P.RevealResponse(request_id=req.request_id, status="error",
                                        error="unknown request")
            if com.root != req.merkle_root:
                return P.RevealResponse(request_id=req.request_id, status="error",
                                        error="root mismatch")
            indices = sorted({int(i) for i in req.leaf_indices})
            if len(indices) > self.config.max_reveal_indices:
                return P.RevealResponse(request_id=req.request_id, status="error",
                                        error="too many indices")
            leaves = []
            with span("merkle_paths"):
                for idx in indices:
                    if not 0 <= idx < len(com.leaves):
                        return P.RevealResponse(request_id=req.request_id, status="error",
                                                error=f"bad index {idx}")
                    t, zb, eb, path = com.open(idx)
                    leaves.append((idx, t, zb, eb, [(h, bool(r)) for h, r in path]))
            return P.RevealResponse(request_id=req.request_id, leaves=leaves)


def _u16(t: torch.Tensor) -> np.ndarray:
    """A bfloat16 tensor's bit patterns as uint16 numpy."""
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _bf16(a: np.ndarray) -> torch.Tensor:
    """uint16 bit patterns back to a bfloat16 tensor."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
