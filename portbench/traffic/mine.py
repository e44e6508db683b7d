"""Miner generation: one client's signed ``InferenceRequest``s handed back to
back to ``Miner.handle_inference``, the call the miner's HTTP service makes
(recorded generation, Merkle commit, proof spool, mp4, signature).

Set-up serves one request of ``warmup_steps`` steps at the configuration's
geometry, which runs every shape a full request runs. The window then
serves requests until ``--seconds`` have passed; the probe ends the window
at the first denoise step after that, and the request in flight there is
abandoned (no reply, not a failure). An error reply is a failure.
"""

from __future__ import annotations

import os
import time

from ..probe import WindowClosed, count_snapshot, span_wrap
from .common import (Context, Record, Requests, Unit, check_plan, completed_by_deadline,
                     through_close, unit_request_data)


class Driver:
    # requests completed by the deadline; denoise steps until the close
    WINDOWS = {"video": completed_by_deadline, "step": through_close}

    def __init__(self, ctx: Context):
        from dvdx_tpu_torch.network.base import Registry
        from dvdx_tpu_torch.network.miner import Miner, MinerConfig
        from dvdx_tpu_torch.verify.proof import Keypair

        self.ctx = ctx
        g = ctx.cfg["geometry"]
        self.plan = check_plan(ctx.rng, ctx.traffic["check"], g["num_steps"], g["num_frames"])
        registry = Registry()
        client = Keypair.from_seed(f"portbench-validator-{ctx.seed}".encode())
        registry.register(client.public_bytes, "mock://validator", role="validator",
                          stake=1_000_000)
        self.miner = Miner(ctx.pipe, Keypair.from_seed(f"portbench-miner-{ctx.seed}".encode()),
                           registry, MinerConfig(spool_dir=os.path.join(ctx.tmp, "spool")))
        self.requests = Requests(ctx, client)
        self.captured = {}
        self._undo = []

    def trace_spans(self, spans) -> None:
        """Host spans around the miner's phases, for a traced run."""
        from dvdx_tpu_torch.network import miner as miner_mod

        for obj, attr, name in ((miner_mod, "MerkleCommitment", "merkle_commit"),
                                (miner_mod, "encode_mp4", "encode_mp4"),
                                (self.miner, "_store_proof", "proof_store_and_spool"),
                                (self.miner.engine, "generate_recorded", "generate_recorded")):
            self._undo.append(span_wrap(obj, attr, name, spans))

    def setup(self) -> None:
        resp = self.miner.handle_inference(
            self.requests.next(num_steps=self.ctx.traffic["warmup_steps"]))
        if resp.status != "ok":
            raise RuntimeError(f"warm-up request failed: {resp.error}")

    def window(self, seconds: float) -> Record:
        probe = self.ctx.probe
        t0 = time.perf_counter()
        rec = Record(t0=t0, deadline=t0 + seconds, counts0=count_snapshot(probe),
                     windows=self.WINDOWS)
        probe.deadline = rec.deadline
        i = 0
        while time.perf_counter() < rec.deadline:
            req = self.requests.next()
            steps, frames = self.plan.get(i, (None, None))
            probe.begin_unit(i in self.plan, steps, frames)
            rec.attempted += 1
            start = time.perf_counter()
            try:
                resp = self.miner.handle_inference(req)
            except WindowClosed:
                cap = probe.end_unit()
                if cap is not None:
                    self.captured[i] = (unit_request_data(req), None, None, cap)
                break
            end = time.perf_counter()
            cap = probe.end_unit()
            ok = resp.status == "ok"
            rec.failed += not ok
            rec.units.append(Unit(start, end, ok, count_snapshot(probe), dict(resp.timings)))
            if cap is not None:
                self.captured[i] = (unit_request_data(req), req.request_id, resp.merkle_root, cap)
            i += 1
        probe.deadline = None
        rec.close(probe)
        return rec

    def collect(self) -> dict:
        """What the output check reads, on the host: each captured unit's
        request, the probe's copies, and the miner's committed leaves and
        root where the request completed."""
        from ..probe import to_host

        units = []
        for i, (req, rid, served_root, cap) in sorted(self.captured.items()):
            leaves = None
            if rid is not None:
                com = self.miner._load_proof(rid)
                leaves = {"timesteps": [int(t) for t in com.timesteps], "zs": com.zs,
                          "epss": com.epss, "leaves": list(com.leaves), "root": com.root,
                          "served_root": served_root}
            units.append({"index": i, "request": req, "capture": to_host(cap),
                          "leaves": leaves})
        return {"units": units}

    def close(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self.miner._proofs.clear()
