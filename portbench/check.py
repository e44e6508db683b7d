"""The output check: what the timed path produced, against the plain
reference at the same inputs.

For each unit the probe kept, the reference (``weights.build_reference``,
float32, TF32 off), called through the configuration's family
(``families/``), works out again from the request alone the token ids, the
text states and the base noise, and from the program's own z_t of each kept
step the two UNet outputs, the guided eps and the DDIM update; it decodes the
program's final latent frames itself. Each number is the worst over the
kept units:

* ``<tensor>_rms`` and ``<tensor>_max``: the root mean square and the
  largest of the elementwise gaps between the program's tensor and the
  reference's, in units of the reference tensor's root mean square, for
  the text states (``text``), the base latent (``noise``, in its own unit
  variance), both UNet outputs (``unet``), the guided eps (``eps``), the
  DDIM update of the program's own z_t and eps_t against its z_{t+1}
  (``ddim``; a step that leaves its state unchanged reads the step's whole
  change) and the decoded frames (``frames``);
* ``leaves`` (miner cells): hashlib leaf hashes and root of the committed
  trace that differ from the program's, plus kept steps whose committed
  leaf is not what the step computed;
* ``proofs`` (audit cells): revealed leaves whose Merkle path does not lead
  to the committed root;
* ``verdicts`` (audit cells): honest audits refused in the warm-up and the
  window, plus 1 if the held-back response with a tampered leaf was not
  refused at its re-execution.

The control is ``reference_view`` of the float8 reference, read in the
program's place at the same inputs; a sound limit refuses it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .families import family
from .reference import merkle as ref_merkle
from .reference.torch_ref import to_fp8


def _rms(x: torch.Tensor) -> float:
    return float(x.double().pow(2).mean().sqrt())


@torch.inference_mode()
def reference_view(data: dict, ref, cfg: dict, device, fp8: bool = False) -> List[dict]:
    """The reference's outputs at each kept unit's inputs, in the layout of
    ``program_view`` (``fp8``: ``ref`` is the control)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fam = family(cfg)
    out = []
    for unit in data["units"]:
        req, cap = unit["request"], unit["capture"]
        ids, hidden = fam.text_states(ref, req, cfg, device)
        noise = fam.base_latent(req, cfg)
        view = {"ids": ids, "text": hidden.cpu(), "noise": to_fp8(noise) if fp8 else noise,
                "steps": {}, "frames": []}
        g = req["guidance_scale"]
        for i, st in cap["steps"].items():
            u = fam.denoise(ref, st["z"], st["t"], hidden[0:1], device)
            c = fam.denoise(ref, st["z"], st["t"], hidden[1:2], device)
            eps = u + g * (c - u)
            step = {"unet": torch.cat([u, c]), "eps": eps, "z": st["z"], "t": st["t"],
                    "num_steps": st["num_steps"]}
            if fp8:
                step["z_next"] = to_fp8(fam.update(st["num_steps"], st["t"], st["z"], eps))
            view["steps"][i] = step
        for idx, z_in, _ in cap["frames"]:
            view["frames"].append((idx, z_in, fam.decode(ref, z_in, cfg, device)))
        out.append(view)
    return out


def program_view(data: dict) -> List[dict]:
    """The program's outputs of each kept unit, in the reference's layout."""
    out = []
    for unit in data["units"]:
        cap = unit["capture"]
        ids, hidden = cap["text"] if cap["text"] is not None else (None, None)
        steps = {i: {"unet": torch.cat(st["unet"]) if st["unet"] else None, "eps": st["eps"],
                     "z": st["z"], "z_next": st["z_next"], "t": st["t"],
                     "num_steps": st["num_steps"]}
                 for i, st in cap["steps"].items()}
        noise = cap["noise"]
        out.append({"ids": ids, "text": hidden, "steps": steps, "frames": cap["frames"],
                    "noise": None if noise is None else noise.reshape(noise.shape[-4:])})
    return out


def numbers(view: List[dict], ref: List[dict], cfg: dict) -> Dict[str, float]:
    """The numbers of a view (the program's or the control's) against the
    reference's, worst over the kept units: for each tensor ``<name>_rms``
    and ``<name>_max`` (text, noise, unet, eps, ddim, frames); the limits
    file names those compared."""
    update = family(cfg).update
    worst: Dict[str, float] = {}

    def put(name, got, want, scale=None):
        if tuple(got.shape) != tuple(want.shape):
            gaps = {"rms": float("inf"), "max": float("inf")}
        else:
            diff = got.double() - want.double()
            s = max(_rms(want) if scale is None else scale, 1e-30)
            gaps = {"rms": _rms(diff) / s, "max": float(diff.abs().max()) / s}
        for form, value in gaps.items():
            key = f"{name}_{form}"
            worst[key] = max(worst.get(key, 0.0), value)

    for v, r in zip(view, ref):
        if v["text"] is not None:
            same_ids = torch.equal(v["ids"].long(), r["ids"].long())
            put("text", v["text"] if same_ids else v["text"][:0], r["text"])
        if v["noise"] is not None:
            put("noise", v["noise"], r["noise"], scale=1.0)
        for i, rs in r["steps"].items():
            vs = v["steps"].get(i)
            if vs is None:
                continue
            if vs["unet"] is not None:
                for k in range(2):
                    put("unet", vs["unet"][k], rs["unet"][k])
            put("eps", vs["eps"], rs["eps"])
            put("ddim", vs["z_next"], update(vs["num_steps"], vs["t"], vs["z"], vs["eps"]))
        for (_, _, fv), (_, _, fr) in zip(v["frames"], r["frames"]):
            put("frames", fv, fr)
    return worst


def _bf16_bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().view(torch.int16).numpy().tobytes()


def integrity(data: dict) -> Dict[str, float]:
    """The exact numbers: ``leaves`` (miner cells), or ``proofs`` and
    ``verdicts`` (audit cells)."""
    out: Dict[str, float] = {}
    if "tamper" in data:
        bad = 0
        for unit in data["units"]:
            for t, zb, eb, path in unit["reveal"]:
                bad += not ref_merkle.verify_path(ref_merkle.leaf_hash(t, zb, eb), path,
                                                  unit["root"])
        out["proofs"] = float(bad)
        tamper = data["tamper"]
        caught = (not tamper["passed"]) and tamper["failed_check"] == "reexecution"
        out["verdicts"] = float(data["window_failed"] + (not data["warmup_passed"])
                                + (not caught))
        return out
    bad = 0
    for unit in data["units"]:
        lv = unit["leaves"]
        if lv is None:
            continue
        hashes = [ref_merkle.leaf_hash(t, _bf16_bytes(lv["zs"][i]), _bf16_bytes(lv["epss"][i]))
                  for i, t in enumerate(lv["timesteps"])]
        bad += sum(a != b for a, b in zip(hashes, lv["leaves"]))
        root = ref_merkle.root(hashes)
        bad += (root != lv["root"]) + (root != lv["served_root"])
        for i, st in unit["capture"]["steps"].items():
            bad += not torch.equal(lv["zs"][i].float(), st["z"].reshape(lv["zs"][i].shape))
            bad += not torch.equal(lv["epss"][i].float(), st["eps"].reshape(lv["epss"][i].shape))
    out["leaves"] = float(bad)
    return out


def judge(found: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{name: {"value", "limit"}} of every number with a limit; a number the
    run could not read (None) is over its limit."""
    return {k: {"value": found[k] if np.isfinite(found.get(k, np.inf)) else None, "limit": lim}
            for k, lim in limits.items()}


def correct(checks: Dict[str, dict]) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
