"""The validator's deep audit: ``Validator._spot_check`` of honest responses,
called as ``verify_response`` step 6 calls it, back to back.

The miner answers the reveal in process over ``network.transport.
MockTransport`` (as ``network.mock.build_mock_network`` wires it, no WAN
delay), with its proof spool on. ``ValidatorConfig`` keeps its defaults (k =
3 re-executed steps with T-1 among them, 2 binding frames) at the
configuration's geometry, and the miner's registry pin is the validator's
own engine tag, so the same-program regime applies. The validator never
scores inside ``_spot_check``, so it is handed a stand-in scorer instead of
building CLIP.

Set-up has the miner serve a pool of ``pool`` honest responses (their
frames decoded from the mp4 once), holds back a copy of the first with one
tampered eps leaf, and audits the first response once, which runs every
shape. Every response of one geometry costs an audit the same work, and
the validator draws the revealed steps anew for each audit, so a pool of
one is enough; each more costs set-up a whole request. The window audits
the pool in turn until ``--seconds`` have passed;
the audit in flight then finishes and is not counted. An honest response
that an audit refuses is a failure.
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import time

from ..probe import count_snapshot, span_wrap
from .common import (Context, Record, Requests, Unit, check_plan, completed_by_deadline,
                     unit_request_data)


class _NoScorer:
    """``_spot_check`` never scores; a call here is a fault of this traffic driver."""

    def score(self, *args, **kwargs):
        raise RuntimeError("the audit cell does not score")


class Driver:
    # audits completed by the deadline
    WINDOWS = {"audit": completed_by_deadline}

    def __init__(self, ctx: Context):
        from dvdx_tpu_torch.network.base import Registry
        from dvdx_tpu_torch.network.miner import Miner, MinerConfig
        from dvdx_tpu_torch.network.transport import MockTransport
        from dvdx_tpu_torch.network.validator import Validator, ValidatorConfig
        from dvdx_tpu_torch.verify.proof import Keypair

        self.ctx = ctx
        g = ctx.cfg["geometry"]
        self.plan = check_plan(ctx.rng, ctx.traffic["check"], g["num_steps"], g["num_frames"])
        self.loop = asyncio.new_event_loop()
        registry = Registry()
        self.transport = MockTransport(seed=ctx.seed)
        self.miner = Miner(ctx.pipe, Keypair.from_seed(f"portbench-miner-{ctx.seed}".encode()),
                           registry, MinerConfig(spool_dir=os.path.join(ctx.tmp, "spool")))
        self.uid = self.miner.register("mock://miner-0", stake=10_000,
                                       platform=self.miner.platform_tag)
        self.transport.serve("mock://miner-0", self.miner.handle)
        vcfg = ValidatorConfig(width=g["width"], height=g["height"],
                               num_frames=g["num_frames"], num_steps=g["num_steps"],
                               fps=g["fps"], guidance_scale=g["guidance_scale"],
                               cfg_split=g["cfg_split"],
                               results_dir=os.path.join(ctx.tmp, "results"))
        self.validator = Validator(
            ctx.pipe, Keypair.from_seed(f"portbench-validator-{ctx.seed}".encode()), registry,
            self.transport, ledger=None, config=vcfg, scorer=_NoScorer())
        self.validator.register("mock://validator", stake=100_000)
        self.requests = Requests(ctx, self.validator.keypair)
        self.pool = []
        self.captured = {}
        self._reveals = []
        self._noise = []
        self._undo = []
        self._wrap()

    def _wrap(self) -> None:
        """Keep the reveal replies and the re-derived base noise of the
        audits the output check reads."""
        engine, transport = self.validator.engine, self.transport
        base_latent, request = engine.base_latent, transport.request

        def kept_base_latent(*args, **kwargs):
            out = base_latent(*args, **kwargs)
            if self.ctx.probe._cap is not None:
                self._noise.append(out.clone())
            return out

        async def kept_request(address, msg, timeout_s=300.0):
            reply = await request(address, msg, timeout_s=timeout_s)
            if self.ctx.probe._cap is not None and type(reply).__name__ == "RevealResponse":
                self._reveals.append(reply)
            return reply

        engine.base_latent = kept_base_latent
        transport.request = kept_request

    def trace_spans(self, spans) -> None:
        """Host spans around the audit's phases, for a traced run."""
        from dvdx_tpu_torch.network import validator as validator_mod

        engine = self.validator.engine
        for obj, attr, name in ((self.miner, "handle_reveal", "miner_reveal"),
                                (validator_mod, "verify_merkle_proof", "merkle_verify"),
                                (engine, "base_latent", "base_noise"),
                                (validator_mod, "verify_revealed_steps", "reexecution"),
                                (engine, "verify_video_binding", "video_binding")):
            self._undo.append(span_wrap(obj, attr, name, spans))

    def _audit(self, req, resp, frames) -> dict:
        d = {"score": 0.0, "checks": {}, "timings_s": {}}
        d["passed"] = self.loop.run_until_complete(
            self.validator._spot_check(self.uid, req, resp, d, frames))
        return d

    def setup(self) -> None:
        from dvdx_tpu_torch.network import protocol as P
        from dvdx_tpu_torch.utils.video_io import decode_video
        from dvdx_tpu_torch.verify.merkle import MerkleCommitment
        from dvdx_tpu_torch.verify.proof import sign_proof

        for _ in range(self.ctx.traffic["pool"]):
            req = self.requests.next()
            resp = self.miner.handle_inference(req)
            if resp.status != "ok":
                raise RuntimeError(f"pool request failed: {resp.error}")
            self.pool.append((req, resp, decode_video(resp.video)))
        # the held-back cheat: the first response's trace with eps_{T-1}
        # shifted, committed and signed under a request of its own
        req0, resp0, frames0 = self.pool[0]
        com = self.miner._load_proof(req0.request_id)
        epss = com.epss.clone()
        epss[-1] = epss[-1] + 0.5
        bad = MerkleCommitment(com.timesteps, com.zs, epss)
        rid = req0.request_id + "-tampered"
        self.miner._store_proof(rid, bad)
        treq = dataclasses.replace(req0, request_id=rid, signature=b"")
        treq.signature = self.validator.keypair.sign(P.signing_bytes(treq))
        tresp = dataclasses.replace(resp0, request_id=rid, merkle_root=bad.root,
                                    signature=sign_proof(self.miner.keypair, req0.challenge,
                                                         req0.seed, resp0.video, bad.root))
        self.tampered = (treq, tresp, frames0)
        self.warmup_passed = self._audit(req0, resp0, frames0)["passed"]

    def window(self, seconds: float) -> Record:
        probe = self.ctx.probe
        t0 = time.perf_counter()
        rec = Record(t0=t0, deadline=t0 + seconds, counts0=count_snapshot(probe),
                     windows=self.WINDOWS)
        i = 0
        while time.perf_counter() < rec.deadline:
            req, resp, frames = self.pool[i % len(self.pool)]
            probe.begin_unit(i in self.plan)
            self._reveals, self._noise = [], []
            rec.attempted += 1
            start = time.perf_counter()
            d = self._audit(req, resp, frames)
            end = time.perf_counter()
            cap = probe.end_unit()
            rec.failed += not d["passed"]
            rec.units.append(Unit(start, end, d["passed"], count_snapshot(probe),
                                  dict(d["timings_s"])))
            if cap is not None:
                self.captured[i] = (req, resp, cap, self._reveals, self._noise, d)
            i += 1
        return rec

    def collect(self) -> dict:
        """What the output check reads, on the host: each captured audit's
        request, the probe's copies of the re-executed steps, text states
        and binding decodes, the re-derived base noise, the reveal's leaves
        and paths, and the verdicts (every audit in the window, and the
        held-back cheat's, audited now)."""
        from ..probe import to_host

        units = []
        for i, (req, resp, cap, reveals, noise, d) in sorted(self.captured.items()):
            cap["noise"] = noise[0] if noise else None
            units.append({"index": i, "request": unit_request_data(req),
                          "capture": to_host(cap), "root": resp.merkle_root,
                          "reveal": [(int(t), bytes(zb), bytes(eb),
                                      [(bytes(h), bool(r)) for h, r in path])
                                     for r_ in reveals for _i, t, zb, eb, path in r_.leaves],
                          "passed": d["passed"]})
        d = self._audit(*self.tampered)
        return {"units": units, "warmup_passed": self.warmup_passed,
                "tamper": {"passed": d["passed"], "failed_check": d.get("failed_check")}}

    def close(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self.miner._proofs.clear()
        self.loop.close()
