"""Validator neuron: challenge, dispatch, verify, score, reward, slash.

Counterpart of ``dvdx_tpu/network/validator.py`` over the port's
``StepEngine``. One round: sign a request with a fresh challenge and the
seed HMAC(key, challenge), ping the sampled miners, fan the request out,
and for each response check echo, identity, the timestep schedule, the
video digest and the proof signature, then the video's authenticity; ask
for the reveals of a post-commit sample of steps, check their Merkle paths,
the seed-derived base noise and the re-execution of every sampled step,
bind the delivered video to the committed final latent, and score it with
MD-VQS. Cheats lose trust and a slice of their stake; the escrow is paid
out pro rata to score and the weight vector is emitted on the ledger. Check
names and the round report's keys, ``timings_s`` phases included, are the
JAX package's, so the two packages' reports read alike.

The verification regime comes from the miner's registry pin, as in the
JAX package's ``_regime``: equal to this validator's own engine tag
("torch-cuda" / "torch-cpu"), the same program runs on both sides and the
leaves must re-execute to the calibrated same-program bound (bitwise
preferred); a strategy pin on this backend ("torch-cuda:hybrid_ctx") gets
that strategy's calibrated bound (``atol_by_strategy``, the JAX package's
values); any other pin (a JAX miner's "cpu" or "cpu:fsdp", a torch miner on
another device) the cross-platform tolerance. A chunked strategy is
re-executed by an engine of the committed chunk plan (the response's
``num_chunks``, checked against the leaves' shape first); value-preserving
strategies re-execute on the plain program; an unknown strategy is refused
at ``platform_pin`` without a slash.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import hashlib
import json
import os
import random
import secrets
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.scheduler import make_ddim_schedule
from ..pipelines.text2video import Pipeline
from ..scoring.clip_score import CLIPScorer
from ..scoring.mdvqs import MDVQS, verify_video_authenticity
from ..utils.profiling import span
from ..utils.video_io import decode_video
from ..verify.merkle import leaf_hash, verify_merkle_proof
from ..verify.proof import (Keypair, derive_seed, sample_spotcheck_indices,
                            verify_proof_signature)
from ..verify.spotcheck import (StepEngine, binding_frame_indices, compare_arrays,
                                verify_revealed_steps)
from . import protocol as P
from .base import Neuron, Registry, ScoreBook
from .ledger import Ledger

# Same-backend tolerances of the sharded and chunked miners' regimes, the
# JAX package's calibrated values (``ValidatorConfig.atol_by_strategy``).
DEFAULT_REGIME_ATOL = {
    "fsdp": 2e-2,
    "cp_exact": 5e-2,
    "cp_ulysses": 5e-2,
    "chunk": 1e-2,
    "hybrid": 1e-1,
    "hybrid_ctx": 1e-1,
}
# chunked verification engines kept between rounds
MAX_CHUNK_ENGINES = 4


@dataclasses.dataclass
class ValidatorConfig:
    sample_size: int = 3            # miners per request
    num_checkpoints: int = 3        # k re-executed steps (T-1 among them)
    challenge_bytes: int = 32
    audit_rate: float = 1.0         # fraction of responses deep-audited
    atol: float = 5e-2              # cross-platform tolerance
    # same-program regime: exact bytes preferred (reexec_bitwise reports
    # it); the gate is elementwise |a - b| <= atol + rtol * |b|, with rtol
    # two bf16 ulps
    atol_same_program: float = 1e-4
    rtol_same_program: float = 2.0 ** -7
    atol_by_strategy: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_REGIME_ATOL))
    ema_alpha: float = 0.1
    kappa_limit: float = 0.1
    trust_decay: float = 0.8        # gamma: fraction of trust a cheat loses
    slash_fraction: float = 0.1     # f*
    timeout_s: float = 300.0
    mdvqs_alpha: float = 0.4
    mdvqs_beta: float = 0.3
    mdvqs_gamma: float = 0.3
    video_binding: bool = True      # bind the delivered video to the trace
    binding_max_err: float = 0.12   # codec-lossy tolerance (mean abs, [-1, 1])
    binding_num_frames: int = 2     # secret-derived frames checked per video
    auth_min_entropy: float = 1.0
    auth_min_frame_diff: float = 0.01
    # liveness probe before dispatch; 0 disables
    ping_timeout_s: float = 3.0
    # non-empty: miners pinned elsewhere score 0 ("platform_policy")
    require_platform: str = ""
    results_dir: str = "generated_videos"
    width: int = 32
    height: int = 32
    num_frames: int = 4
    num_steps: int = 4
    fps: int = 8
    guidance_scale: float = 7.5
    cfg_split: bool = False
    min_score_to_record: float = 0.0

    @classmethod
    def from_economics(cls, gamma: float = 0.8, margin: float = 0.0,
                       params=None, verify_budget_fraction: float = 0.0,
                       **overrides) -> "ValidatorConfig":
        """The protocol knobs from the economics: the cheapest (audit rate
        alpha, slash fraction f) with EV_cheat < EV_honest for every tamper
        strategy at trust decay ``gamma``. With ``verify_budget_fraction`` >
        0 also the smallest secure spot-check count k with k / num_steps
        within that budget (``economics.optimize.min_checkpoints_secure``;
        0.10 at T = 25 gives k = 2). Raises if no secure point exists."""
        from ..economics.optimize import cheapest_secure_point, min_checkpoints_secure
        from ..economics.params import DEFAULT

        p = params or DEFAULT
        if verify_budget_fraction > 0:
            t = int(overrides.get("num_steps", cls.num_steps))
            pt = min_checkpoints_secure(p, gamma=gamma, t_steps=t,
                                        budget_fraction=verify_budget_fraction,
                                        margin=margin)
            k = pt.get("k", p.num_checkpoints)
        else:
            pt = cheapest_secure_point(p, gamma=gamma, margin=margin)
            k = p.num_checkpoints
        if not pt.get("feasible"):
            raise ValueError(f"no secure (alpha, f) region at gamma={gamma}")
        base = dict(audit_rate=pt["alpha"], slash_fraction=pt["f"],
                    trust_decay=gamma, num_checkpoints=k)
        base.update(overrides)
        return cls(**base)


class Validator(Neuron):
    def __init__(self, pipeline: Pipeline, keypair: Keypair, registry: Registry,
                 transport, ledger: Optional[Ledger] = None,
                 config: Optional[ValidatorConfig] = None,
                 scorer: Optional[MDVQS] = None):
        super().__init__(keypair=keypair, registry=registry, role="validator")
        self.pipeline = pipeline
        self.engine = StepEngine(pipeline)
        self.transport = transport
        self.ledger = ledger
        self.config = config or ValidatorConfig()
        self.scores = ScoreBook(alpha=self.config.ema_alpha,
                                kappa_limit=self.config.kappa_limit)
        self.scorer = scorer or MDVQS(CLIPScorer.build(device=pipeline.device),
                                      alpha=self.config.mdvqs_alpha,
                                      beta=self.config.mdvqs_beta,
                                      gamma=self.config.mdvqs_gamma)
        self.metrics = {"rounds": 0, "responses": 0, "failures": 0,
                        "cheats_detected": 0, "reexec_steps": 0, "ledger_errors": 0}
        # (strategy, num_chunks) -> chunked verification engine, least
        # recently used first; a miner picks num_chunks, so the cache is
        # bounded
        self._chunk_engines: "collections.OrderedDict[Tuple[str, int], StepEngine]" = (
            collections.OrderedDict())

    def _chunk_engine(self, strategy_name: str, num_chunks: int) -> StepEngine:
        """The single-device engine of the chunked program a miner pinned
        and committed to."""
        from ..parallel.strategies import get_strategy

        key = (strategy_name, int(num_chunks))
        eng = self._chunk_engines.pop(key, None)
        if eng is None:
            eng = StepEngine(self.pipeline,
                             strategy=get_strategy(strategy_name, num_chunks=num_chunks))
        self._chunk_engines[key] = eng
        while len(self._chunk_engines) > MAX_CHUNK_ENGINES:
            self._chunk_engines.popitem(last=False)
        return eng

    def _regime(self, pinned: str) -> Tuple[bool, float, str]:
        """Registry pin -> (same_platform, atol, strategy_name). An empty pin
        or this engine's own tag: the same-program bound; this backend with
        a strategy: the strategy's calibrated bound; another backend: the
        cross-platform atol (with its strategy's program where it names
        one)."""
        if not pinned:
            return True, self.config.atol_same_program, ""
        pin_backend, _, strat = pinned.partition(":")
        if pin_backend != self.engine.platform_tag:
            return False, self.config.atol, strat
        if not strat:
            return True, self.config.atol_same_program, ""
        return False, self.config.atol_by_strategy.get(strat, self.config.atol), strat

    def _audit_decision(self) -> Tuple[bool, str]:
        """Audit-or-skip from OS entropy, so no miner can predict the
        unaudited rounds; the raw draw goes into the report."""
        draw = secrets.randbits(53) / float(1 << 53)
        return draw < self.config.audit_rate, f"{draw:.12f}"

    # -- round orchestration --

    def make_challenge(self) -> Tuple[bytes, int]:
        c = secrets.token_bytes(self.config.challenge_bytes)
        return c, derive_seed(self.pubkey, c)

    def build_request(self, request_id: str, prompt: str, challenge: bytes,
                      seed: int) -> P.InferenceRequest:
        cfg = self.config
        req = P.InferenceRequest(
            request_id=request_id, prompt=prompt, width=cfg.width, height=cfg.height,
            num_frames=cfg.num_frames, fps=cfg.fps, num_steps=cfg.num_steps,
            guidance_scale=cfg.guidance_scale, seed=seed, challenge=challenge,
            validator_pubkey=self.pubkey, cfg_split=cfg.cfg_split,
            issued_at=time.time())
        req.signature = self.keypair.sign(P.signing_bytes(req))
        return req

    async def _ping(self, uid: int, timeout_s: float, require_idle: bool) -> bool:
        info = self.registry.get(uid)
        nonce = random.getrandbits(32)
        try:
            pong = await self.transport.request(info.address, P.Ping(nonce=nonce),
                                                timeout_s=timeout_s)
        except Exception:  # a transport failure is a dead miner here
            return False
        return (isinstance(pong, P.Pong) and pong.nonce == nonce
                and not (require_idle and pong.busy))

    async def _ping_filter(self, uids: List[int], cfg) -> List[int]:
        """Ping each sampled miner, drop non-responders, and top the sample
        back up from never-tried miners until it is full or the registry is
        exhausted."""
        async def ping(uid):
            return await self._ping(uid, cfg.ping_timeout_s, require_idle=True)

        oks = await asyncio.gather(*[ping(u) for u in uids])
        live = [u for u, ok in zip(uids, oks) if ok]
        self.metrics["ping_failures"] = (
            self.metrics.get("ping_failures", 0) + len(uids) - len(live))
        want, tried = len(uids), set(uids)
        while len(live) < want:
            pool = [u for u in self.registry.sample_miner_uids(
                len(self.registry.neurons), min_stake=1) if u not in tried]
            if not pool:
                break
            batch = pool[:max(want - len(live), 1) * 2]
            tried.update(batch)
            oks = await asyncio.gather(*[ping(u) for u in batch])
            live += [u for u, ok in zip(batch, oks) if ok]
            self.metrics["ping_failures"] += sum(1 for ok in oks if not ok)
        return sorted(live[:want])

    async def _is_reachable(self, info) -> bool:
        """Separates a crashed miner from one that refuses its reveal."""
        return await self._ping(info.uid, max(self.config.ping_timeout_s, 1.0),
                                require_idle=False)

    async def run_round(self, request_id: str, prompt: str) -> dict:
        """One full verification round over sampled miners."""
        cfg = self.config
        self.metrics["rounds"] += 1
        challenge, seed = self.make_challenge()
        req = self.build_request(request_id, prompt, challenge, seed)

        uids = self.registry.sample_miner_uids(cfg.sample_size, min_stake=1)
        if uids and cfg.ping_timeout_s > 0:
            uids = await self._ping_filter(uids, cfg)
        if not uids:
            return {"request_id": request_id, "error": "no miners available"}
        ledger_error = ""

        async def ask(uid):
            info = self.registry.get(uid)
            try:
                return uid, await self.transport.request(info.address, req,
                                                         timeout_s=cfg.timeout_s)
            except Exception as e:
                return uid, P.InferenceResponse(request_id=request_id, status="error",
                                                error=f"transport: {e}")

        results = await asyncio.gather(*[ask(u) for u in uids])

        per_miner = {}
        rewards, reward_uids = [], []
        for uid, resp in results:
            self.metrics["responses"] += 1
            try:
                detail = await self.verify_response(uid, req, resp)
            except Exception as e:  # one miner's response must not end the round
                self.metrics["verify_exceptions"] = (
                    self.metrics.get("verify_exceptions", 0) + 1)
                detail = {"score": 0.0, "checks": {}, "failed_check": "verify_exception",
                          "error": f"{type(e).__name__}: {e}"}
            if resp.status == "ok" and resp.video and not detail.get("cheat"):
                os.makedirs(cfg.results_dir, exist_ok=True)
                vpath = os.path.join(cfg.results_dir, f"{request_id}_miner{uid}.mp4")
                with open(vpath, "wb") as f:
                    f.write(resp.video)
                detail["video_path"] = vpath
            per_miner[uid] = detail
            rewards.append(detail["score"])
            reward_uids.append(uid)
            self.registry.update_trust(uid, detail.get("cheat", False),
                                       decay=cfg.trust_decay)
            if detail.get("cheat"):
                self.metrics["cheats_detected"] += 1
                if self.ledger is not None:
                    self.ledger.slash_stake("validator", self._account(self.registry.get(uid)),
                                            cfg.slash_fraction)

        self.scores.update_many(reward_uids, rewards)

        if self.ledger is not None:
            for uid, detail in per_miner.items():
                if detail["score"] > cfg.min_score_to_record and not detail.get("cheat"):
                    proof_bytes = (bytes.fromhex(detail.get("merkle_root", ""))
                                   + bytes.fromhex(detail.get("signature", "")))
                    try:
                        self.ledger.record_submission(
                            "validator", request_id, self._account(self.registry.get(uid)),
                            detail["score"], proof_bytes)
                    except Exception as e:
                        detail["ledger_error"] = str(e)
                        self.metrics["ledger_errors"] += 1
            try:
                self.ledger.distribute_rewards("validator", request_id)
            except Exception as e:  # reported, not swallowed
                ledger_error = f"distribute_rewards: {e}"
                self.metrics["ledger_errors"] += 1

        weights_epoch = self.emit_weights()
        report = {"request_id": request_id, "prompt": prompt,
                  "challenge": challenge.hex(), "seed": seed,
                  "miners": {str(u): d for u, d in per_miner.items()},
                  "weights": self.scores.weights(), "timestamp": time.time()}
        if weights_epoch is not None:
            report["weights_epoch"] = weights_epoch
        if ledger_error:
            report["ledger_error"] = ledger_error
        self._write_results(request_id, report)
        return report

    def emit_weights(self):
        """Record the kappa-clipped u16 weight vector on the ledger; returns
        the new epoch, or None without a ledger or scores."""
        if self.ledger is None:
            return None
        w = self.scores.weights_u16()
        if not w:
            return None
        uids = sorted(w)
        try:
            return self.ledger.set_weights("validator", uids, [w[u] for u in uids])
        except Exception as e:
            self.metrics["ledger_errors"] += 1
            self.metrics["weights_emit_error"] = str(e)
            return None

    def _account(self, info) -> str:
        return f"miner-{info.uid}" if info else "miner-?"

    # -- response verification --

    async def verify_response(self, uid: int, req: P.InferenceRequest,
                              resp: P.InferenceResponse) -> dict:
        async with span("validator.verify"):
            cfg = self.config
            d: dict = {"score": 0.0, "checks": {}, "timings_s": {}}
            if resp.status == "ok":
                d["gen_time_s"] = resp.gen_time_s
                d["video_bytes"] = len(resp.video) if resp.video else 0

            def fail(name, cheat=False, **extra):
                d["checks"][name] = False
                d["failed_check"] = name
                d["cheat"] = cheat
                d.update(extra)
                self.metrics["failures"] += 1
                return d

            if resp.status != "ok":
                return fail("status", error=resp.error)

            # 1. echo integrity
            if resp.challenge != req.challenge or int(resp.seed) != int(req.seed):
                return fail("echo", cheat=True)
            if int(resp.num_steps) != int(req.num_steps):
                return fail("num_steps", cheat=True)
            d["checks"]["echo"] = True

            # 2. the miner's identity is its registry entry's
            info = self.registry.get(uid)
            if info is None or resp.miner_pubkey != info.pubkey:
                return fail("identity", cheat=True)
            d["checks"]["identity"] = True

            # 3. the committed timesteps are the canonical schedule
            expected_ts = make_ddim_schedule(req.num_steps).timesteps
            if list(map(int, resp.timesteps)) != [int(t) for t in expected_ts]:
                return fail("timesteps", cheat=True)
            d["checks"]["timesteps"] = True

            # 4. video digest and the proof signature
            if hashlib.sha256(resp.video).digest() != resp.video_sha256:
                return fail("video_digest", cheat=True)
            if not verify_proof_signature(resp.miner_pubkey, req.challenge, req.seed,
                                          resp.video, resp.merkle_root, resp.signature):
                return fail("signature", cheat=True)
            d["checks"]["signature"] = True
            d["merkle_root"] = resp.merkle_root.hex()
            d["signature"] = resp.signature.hex()

            # 5. decode and authenticity; the decoded frames go to the device
            # once, for the authenticity reductions and MD-VQS alike
            timings = d["timings_s"]
            try:
                with span("video_decode", timings, accumulate=True):
                    frames = decode_video(resp.video)
            except Exception as e:
                return fail("video_decode", error=str(e))
            with span("authenticity", timings, accumulate=True):
                with span("wait.frames_upload"):
                    frames_dev = torch.from_numpy(frames).to(self.pipeline.device)
                auth = verify_video_authenticity(frames_dev, min_entropy=cfg.auth_min_entropy,
                                                 min_diff=cfg.auth_min_frame_diff,
                                                 host_frames=frames)
            d["authenticity"] = auth
            if not auth["authentic"]:
                return fail("authenticity", cheat=True)
            d["checks"]["authenticity"] = True

            # 6. commit-then-reveal spot check with re-execution
            do_audit, draw = self._audit_decision()
            d["audited"] = do_audit
            d["audit_draw"] = draw
            if do_audit and not await self._spot_check(uid, req, resp, d, frames):
                return d  # _spot_check recorded the failure

            # 7. quality score
            with span("mdvqs_score", timings, accumulate=True):
                q = self.scorer.score(frames, req.prompt, auth=auth, frames_dev=frames_dev)
            d["mdvqs"] = q
            d["score"] = q["score"] * float(self.registry.get(uid).trust)
            d["frames_shape"] = list(frames.shape)
            d["video_bytes"] = len(resp.video)
            d["gen_time_s"] = resp.gen_time_s
            if resp.timings:  # advisory, untrusted
                d["miner_timings_s"] = {str(k): float(v) for k, v in resp.timings.items()}
            return d

    async def _spot_check(self, uid: int, req: P.InferenceRequest,
                          resp: P.InferenceResponse, d: dict, frames=None) -> bool:
        """The deep audit of one response; False where it failed (``d``
        records the failure)."""
        async with span("audit"):
            try:
                await self._audit(uid, req, resp, d, frames)
            except _Refused:
                return False
            return True

    async def _audit(self, uid: int, req: P.InferenceRequest,
                     resp: P.InferenceResponse, d: dict, frames) -> None:
        """``_spot_check``'s body: raises ``_Refused`` at the first failure.
        A phase that fails records no seconds in ``d["timings_s"]``."""
        cfg = self.config

        def fail(name, cheat=True, **extra) -> "_Refused":
            d["checks"][name] = False
            d["failed_check"] = name
            d["cheat"] = cheat
            d.update(extra)
            self.metrics["failures"] += 1
            return _Refused(name)

        timings = d["timings_s"]
        # fresh audit randomness drawn after the root arrived, published in
        # the report. Step T-1 is always re-executed (the video binding
        # decodes the latent it derives) and counts toward the k budget;
        # step 0 is always revealed, for the base-noise check
        audit_secret = secrets.token_bytes(16)
        sampled = sample_spotcheck_indices(resp.merkle_root, req.challenge,
                                           req.num_steps - 1,
                                           max(0, cfg.num_checkpoints - 1),
                                           secret=audit_secret)
        checks = sorted(set(sampled) | {req.num_steps - 1})
        indices = sorted({0, req.num_steps - 1} | set(checks)
                         | {i + 1 for i in checks if i + 1 < req.num_steps})
        d["spotcheck_indices"] = checks
        d["audit_secret"] = audit_secret.hex()

        info = self.registry.get(uid)
        reveal_req = P.RevealRequest(request_id=req.request_id,
                                     merkle_root=resp.merkle_root, leaf_indices=indices,
                                     validator_pubkey=self.pubkey, issued_at=time.time())
        reveal_req.signature = self.keypair.sign(P.signing_bytes(reveal_req))
        async with span("reveal_roundtrip", timings, accumulate=True):
            reveal, reveal_error = None, ""
            for _attempt in (0, 1):  # one retry absorbs a transient loss
                try:
                    reveal = await self.transport.request(info.address, reveal_req,
                                                          timeout_s=cfg.timeout_s)
                    break
                except Exception as e:
                    reveal_error = str(e)
            if reveal is None:
                # unreachable: no slash (it may have crashed, or the fault is
                # ours); reachable but dropping a third reveal: refusal, slashed
                if not await self._is_reachable(info):
                    raise fail("reveal_unreachable", cheat=False, error=reveal_error)
                try:
                    reveal = await self.transport.request(info.address, reveal_req,
                                                          timeout_s=cfg.timeout_s)
                except Exception as e:
                    raise fail("reveal_refused", cheat=True,
                               error=f"reachable but dropped 3 reveals: {e}")
            if not isinstance(reveal, P.RevealResponse) or reveal.status != "ok":
                # an error reply to the reveal of a root committed seconds ago
                # is a refusal
                raise fail("reveal_refused", cheat=True,
                           error=getattr(reveal, "error", "bad reply"))

        with span("leaf_verify", timings, key="merkle_verify", accumulate=True):
            try:
                dtype = _leaf_dtype(resp.latent_dtype)
                shape = tuple(int(s) for s in resp.latent_shape)
            except Exception as e:  # miner-controlled garbage must not crash us
                raise fail("malformed_response", error=str(e))
            try:
                revealed = {int(leaf[0]): leaf for leaf in reveal.leaves}
            except Exception as e:
                raise fail("malformed_response", error=str(e))
            if sorted(revealed) != indices:
                raise fail("reveal_indices")
            leaves: Dict[int, Tuple[int, torch.Tensor, torch.Tensor]] = {}
            for idx in indices:
                try:
                    _, t, zb, eb, path = revealed[idx]
                    z = _leaf_tensor(zb, dtype, shape)
                    eps = _leaf_tensor(eb, dtype, shape)
                except Exception as e:  # malformed tuple arity included
                    raise fail("leaf_decode", error=str(e))
                path_t = [(bytes(h), bool(r)) for h, r in path]
                with span("leaf_hash"):
                    hashed = leaf_hash(int(t), z, eps)
                if not verify_merkle_proof(hashed, path_t, resp.merkle_root):
                    raise fail("merkle_path", leaf=idx)
                if int(t) != int(resp.timesteps[idx]):
                    raise fail("leaf_timestep", leaf=idx)
                leaves[idx] = (int(t), z, eps)
        d["checks"]["merkle"] = True

        # the response's platform tag is untrusted: only the registry pin
        # relaxes the check, and a response contradicting its pin is a cheat
        pinned = info.platform
        if pinned and resp.platform and resp.platform != pinned:
            raise fail("platform", claimed=resp.platform, pinned=pinned)
        if cfg.require_platform and pinned and pinned != cfg.require_platform:
            raise fail("platform_policy", cheat=False, pinned=pinned,
                       required=cfg.require_platform)
        same_platform, atol, strat_name = self._regime(pinned)
        d["same_platform"] = same_platform
        d["regime_atol"] = atol

        # the engine of the pinned program: value-preserving strategies run
        # the plain one, a chunked strategy the committed chunk plan's
        engine, ctx = self.engine, None
        if strat_name:
            from ..parallel.strategies import get_strategy

            try:
                strat = get_strategy(strat_name)
            except KeyError:
                raise fail("platform_pin", cheat=False, pinned=pinned)
            if strat.chunked:
                n = int(resp.num_chunks or 0)
                if not 1 <= n <= req.num_frames:
                    raise fail("chunk_plan", chunks=n)
                engine = self._chunk_engine(strat_name, n)
                plan = engine.chunk_plan(req.num_frames)
                spec = self.pipeline.spec
                ds = spec.vae.downscale
                expected = (plan.num_chunks, plan.chunk_len, req.height // ds,
                            req.width // ds, spec.latent_channels)
                if shape != expected:
                    raise fail("latent_shape", got=list(shape), expected=list(expected))
                # the miner's CCI context is a function of the base noise
                ctx = engine.context_latent(req.seed, req.num_frames, req.height,
                                            req.width)
        d["verify_engine"] = strat_name if engine is not self.engine else ""
        rtol = cfg.rtol_same_program if same_platform else 0.0

        # base-noise binding: z_0 is the seed-derived base latent (the
        # gathered chunk stack for a chunked regime)
        with span("base_noise", timings, accumulate=True):
            if 0 in leaves:
                base = engine.base_latent(req.seed, req.num_frames, req.height, req.width)
                with span("compare"):
                    ok, err, _bit = compare_arrays(leaves[0][1], base,
                                                   bitwise=same_platform, atol=atol,
                                                   rtol=rtol)
                if not ok:
                    raise fail("base_noise", err=err)
                d["checks"]["base_noise"] = True

        with span("reexecution", timings, accumulate=True):
            results, _ = verify_revealed_steps(
                engine, req.prompt, req.negative_prompt, leaves, checks,
                req.num_steps, req.guidance_scale, same_platform=same_platform,
                atol=atol, rtol=rtol, cfg_split=req.cfg_split, ctx=ctx)
        self.metrics["reexec_steps"] += len(checks)
        for i in checks:
            res = results[i]
            if not res.passed:
                raise fail("reexecution", step=i, reason=res.reason,
                           eps_err=res.max_eps_err, z_err=res.max_z_err)
        d["checks"]["reexecution"] = True
        d["reexec_bitwise"] = all(results[i].bitwise for i in checks)
        d["reexec_max_err"] = max(max(results[i].max_eps_err, results[i].max_z_err)
                                  for i in checks)

        # video <-> trace binding on post-commit, secret-derived frames
        if cfg.video_binding and frames is not None:
            with span("video_binding", timings, accumulate=True):
                last = req.num_steps - 1
                bind_frames = binding_frame_indices(audit_secret, resp.merkle_root,
                                                    req.num_frames,
                                                    k=cfg.binding_num_frames)
                d["binding_frames"] = bind_frames
                ok_bind, err = engine.verify_video_binding(
                    frames, leaves[last], last, req.num_steps, req.guidance_scale,
                    req.prompt, req.negative_prompt, frame_indices=bind_frames,
                    max_err=cfg.binding_max_err, num_frames=req.num_frames)
            d["video_binding_err"] = round(err, 4)
            if not ok_bind:
                raise fail("video_binding", err=err)
            d["checks"]["video_binding"] = True

    def _write_results(self, request_id: str, report: dict):
        os.makedirs(self.config.results_dir, exist_ok=True)
        path = os.path.join(self.config.results_dir, f"results_{request_id}.json")
        with open(path, "w") as f:
            json.dump(report, f, indent=2, default=str)


class _Refused(Exception):
    """An audit's failure, already recorded in its report."""


def _leaf_dtype(name: str):
    """A response's latent_dtype -> the numpy dtype its leaf bytes are read
    with, and the torch dtype they are viewed as."""
    if name == "bfloat16":
        return np.dtype(np.int16), torch.bfloat16
    np_dtype = np.dtype(name)
    return np_dtype, torch.from_numpy(np.zeros(0, np_dtype)).dtype


def _leaf_tensor(raw: bytes, dtype, shape) -> torch.Tensor:
    """Little-endian leaf bytes -> a CPU tensor of ``shape``."""
    np_dtype, torch_dtype = dtype
    arr = np.frombuffer(raw, np_dtype).reshape(shape).copy()
    return torch.from_numpy(arr).view(torch_dtype)
