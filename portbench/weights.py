"""Seeded weights in the published checkpoints' layout, the port's pipeline
built from them through its own converter, and the plain reference built
from the same draw.

The draw is one ``torch.randn`` over every parameter of the family's state
dicts (its reference modules' keys and shapes, which are the published
checkpoints'), on the run's device from a ``torch.Generator`` seeded with
``--seed``, in the served dtype; each tensor is a slice of it, scaled in
place as the family's ``spread`` says.

The port receives float32 host copies of those tensors through the
family's ``load`` (the port's own converter), as it would read a
checkpoint; nothing is written to disk. The reference draws the same
tensors again on the same device after the measured window and computes in
float32.
"""

from __future__ import annotations

import math
import time
import types
from typing import Dict, List, Tuple

import torch

from .families import family


def layout(cfg: dict) -> List[Tuple[str, str, Tuple[int, ...]]]:
    """(component, key, shape) of every tensor drawn, in draw order."""
    fam = family(cfg)
    with torch.device("meta"):
        mods = fam.reference_modules(cfg)
    return [(c, k, tuple(p.shape)) for c in fam.COMPONENTS
            for k, p in mods[c].state_dict().items()]


def draw(cfg: dict, seed: int, device, dtype: torch.dtype) -> Dict[str, Dict[str, torch.Tensor]]:
    """{component: {key: tensor}} on ``device`` in ``dtype``, views of one
    seeded draw."""
    fam = family(cfg)
    entries = layout(cfg)
    total = sum(math.prod(s) for _, _, s in entries)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out: Dict[str, Dict[str, torch.Tensor]] = {c: {} for c in fam.COMPONENTS}
    off = 0
    with torch.no_grad():
        for comp, key, shape in entries:
            n = math.prod(shape)
            t = flat[off:off + n].view(shape)
            scale, shift = fam.spread(comp, key, shape)
            t.mul_(scale)
            if shift:
                t.add_(shift)
            out[comp][key] = t
            off += n
    return out


def build_pipeline(cfg: dict, seed: int, device, phases: dict = None):
    """The port's pipeline with the seeded weights, converted in memory;
    ``phases`` receives the seconds of the draw, the copies to the host,
    and the program's convert and load."""
    fam = family(cfg)
    phases = {} if phases is None else phases
    t = time.perf_counter()
    pipe = fam.empty_pipeline(cfg, device)
    sds = draw(cfg, seed, device, getattr(torch, cfg["dtype"]))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    phases["draw"] = time.perf_counter() - t
    for comp in fam.COMPONENTS:
        # one copy of the component to the host, then float32 numpy views
        t = time.perf_counter()
        host = {k: v.to("cpu") for k, v in sds.pop(comp).items()}
        sd = {k: v.float().numpy() for k, v in host.items()}
        del host
        t1 = time.perf_counter()
        fam.load(pipe, cfg, comp, sd)
        del sd
        phases["to_host"] = phases.get("to_host", 0.0) + t1 - t
        phases["convert_and_load"] = (phases.get("convert_and_load", 0.0)
                                      + time.perf_counter() - t1)
    return pipe


def build_reference(cfg: dict, seed: int, device, fp8: bool = False):
    """The float32 reference of the same draw, one attribute per component
    (``fp8``: the control)."""
    from .reference.torch_ref import lower_precision

    fam = family(cfg)
    sds = draw(cfg, seed, device, getattr(torch, cfg["dtype"]))
    with torch.device("meta"):
        mods = fam.reference_modules(cfg)
    for comp in fam.COMPONENTS:
        m = mods[comp].to_empty(device=device)
        m.load_state_dict({k: t.float() for k, t in sds.pop(comp).items()})
        m.eval().requires_grad_(False)
        if fp8:
            lower_precision(m)
        mods[comp] = m
    return types.SimpleNamespace(**mods)
