"""What the traffic drivers share: the run's context, the seeded requests a
validator signs, and the record of a measured window.

Every request's prompt, 64-bit generation seed and 32-byte challenge come
from the run's ``numpy`` generator, seeded with ``--seed``; every request has
the configuration's geometry, so every seed asks for the same work.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..probe import Probe, count_snapshot

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Context:
    cfg: dict
    traffic: dict
    seed: int
    pipe: object
    probe: Probe
    rng: np.random.Generator
    tmp: str


@dataclasses.dataclass
class Unit:
    start: float
    end: float
    ok: bool
    counts: Dict[str, int]
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)


def completed_by_deadline(rec: "Record") -> Optional[dict]:
    """From the window's start to the end of its last unit completed by the
    deadline."""
    counted = [u for u in rec.units if u.end <= rec.deadline]
    if not counted:
        return None
    return {"t0": rec.t0, "t1": counted[-1].end, "units": counted,
            "counts": counted[-1].counts}


def through_close(rec: "Record") -> Optional[dict]:
    """From the window's start to where the probe closed it at a step
    boundary (or, where no unit was in flight, the end of the last unit)."""
    if rec.closed_at is not None:
        t1, counts = rec.closed_at, rec.closed_counts
    elif rec.units:
        t1, counts = rec.units[-1].end, rec.units[-1].counts
    else:
        return None
    return {"t0": rec.t0, "t1": t1, "units": [u for u in rec.units if u.end <= t1],
            "counts": counts}


@dataclasses.dataclass
class Record:
    """A window: its start, deadline, each unit of work in order, and where
    the probe closed it inside a unit (or None). ``windows`` maps the names
    of the spans a metric can be taken over (a per-layer metric's suffix) to
    the functions that cut them from the record; each driver names its own."""

    t0: float
    deadline: float
    counts0: Dict[str, int]
    windows: Dict[str, Callable[["Record"], Optional[dict]]]
    units: List[Unit] = dataclasses.field(default_factory=list)
    closed_at: Optional[float] = None
    closed_counts: Optional[Dict[str, int]] = None
    attempted: int = 0
    failed: int = 0

    def window(self, name: str) -> Optional[dict]:
        """The window ``name``: its start and end on the host clock, the
        units of work inside it, and the counts at its end (None where the
        driver has no such window or it holds no work)."""
        cut = self.windows.get(name)
        return cut(self) if cut is not None else None

    def close(self, probe: Probe) -> None:
        if probe.closed_at is not None:
            self.closed_at, self.closed_counts = probe.closed_at, count_snapshot(probe)


def prompts(traffic: dict) -> List[str]:
    with open(os.path.join(HERE, traffic["prompts"])) as f:
        return [line.strip() for line in f if line.strip()]


def check_plan(rng: np.random.Generator, check: dict, num_steps: int, num_frames: int):
    """Which units the output check reads (the first ones and one drawn from
    a range), and in each which steps and decoded frames."""
    units = set(range(check["first_units"]))
    lo, hi = check["extra_unit_between"]
    units.add(int(rng.integers(lo, hi)))
    plan = {}
    for u in sorted(units):
        steps = sorted(int(i) for i in rng.choice(num_steps, check.get("steps", num_steps),
                                                  replace=False))
        frames = sorted(int(i) for i in rng.choice(num_frames, check.get("frames", num_frames),
                                                   replace=False))
        plan[u] = (steps, frames)
    return plan


class Requests:
    """Signed ``InferenceRequest``s of one validator identity, drawn in order
    from the run's generator."""

    def __init__(self, ctx: Context, keypair):
        self.ctx, self.keypair = ctx, keypair
        self.prompts = prompts(ctx.traffic)
        self.n = 0

    def next(self, num_steps: Optional[int] = None):
        from dvdx_tpu_torch.network import protocol as P
        from dvdx_tpu_torch.verify.proof import derive_seed

        g, rng = self.ctx.cfg["geometry"], self.ctx.rng
        prompt = self.prompts[int(rng.integers(len(self.prompts)))]
        challenge = rng.bytes(32)
        req = P.InferenceRequest(
            request_id=f"r{self.n}-{challenge[:4].hex()}", prompt=prompt,
            negative_prompt=self.ctx.traffic["negative_prompt"], width=g["width"],
            height=g["height"], num_frames=g["num_frames"], fps=g["fps"],
            num_steps=num_steps or g["num_steps"], guidance_scale=g["guidance_scale"],
            seed=derive_seed(self.keypair.public_bytes, challenge), challenge=challenge,
            validator_pubkey=self.keypair.public_bytes, cfg_split=g["cfg_split"],
            issued_at=time.time())
        req.signature = self.keypair.sign(P.signing_bytes(req))
        self.n += 1
        return req


def unit_request_data(req) -> dict:
    """The parts of a request the reference reads."""
    return {"prompt": req.prompt, "negative_prompt": req.negative_prompt, "seed": int(req.seed),
            "num_steps": int(req.num_steps), "guidance_scale": float(req.guidance_scale),
            "num_frames": int(req.num_frames), "height": int(req.height),
            "width": int(req.width)}
