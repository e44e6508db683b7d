"""One run of one cell: set-up, the measured window, the metrics, and the
output check against the plain reference.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration's file (whose ``family`` names the module of
``families/`` that knows the model's layout), ``traffic/<traffic>.json``
(which names its driver, ``traffic/<driver>.py``, and the driver names its
windows), ``limits/<cell>.json`` and one reader in ``metrics/`` per metric
family. ``run_cell`` takes a device, so the tests
drive it on the CPU at a small size; the command line (``run.py``) runs it
on the card only.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import os
import shutil
import tempfile
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from . import check, costs, metrics, weights
from .families import family
from .probe import Probe
from .trace import Trace, busy_us, merged
from .traffic.common import Context

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Run:
    record: object
    setup_s: float
    trace: Optional[Trace]
    flops: Optional[dict]
    bounds: Optional[dict]
    decode_events: list
    spans: list


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, cell: dict, root: str):
    """(configuration, traffic mix) of a cell, by name."""
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))
    return cfg, traffic


def cell_limits(cell: dict) -> dict:
    return load_json(os.path.join(HERE, "limits", f"{cell['name']}.json"))


def cell_metrics(bench: dict, cell: dict, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: the end-to-end ones with
    ``--trace 0``, the per-layer ones with ``--trace 1``."""
    pool = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in pool if cell["name"] in m.get("workloads", [cell["name"]])]


def _bounds(pipe, cfg: dict, device) -> dict:
    """{probe counter: each model-path kernel's launches and bound in one
    counted unit of work at the cell's shapes}."""
    with torch.inference_mode():
        return {counter: costs.launch_bounds(module, call)
                for counter, (module, call) in family(cfg).bound_calls(pipe, cfg, device).items()}


def breakdown(run: Run, t0: float, t1: float) -> dict:
    """The ten device operations that took most time in [t0, t1], and the ten
    longest idle gaps, each named by the innermost host span around its
    middle."""
    events = run.trace.within(t0, t1)
    by_name = {}
    for n, s, e in events:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    busy = merged([(s, e) for _, s, e in events])
    edges = [t0] + [x for s, e in busy for x in (s, e)] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    out = []
    for gs, ge in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (gs + ge)
        around = [(e - s, n) for n, s, e in run.spans if s <= mid <= e]
        out.append([min(around)[1] if around else "host, outside the spans", ge - gs])
    return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": out}


def device_info(device, count: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, root: str = ".", control: bool = False,
             limits: Optional[dict] = None, fault: Optional[Callable] = None,
             log=print) -> dict:
    """One run of ``cell``; returns the result line's fields and, under
    ``readings``, every number the check read (``control``: also the float8
    control's). Tests hand their own ``limits`` and a ``fault`` that breaks
    the program under the probe before set-up."""
    cfg, traffic = cell_files(bench, cell, root)
    limits = cell_limits(cell) if limits is None else limits
    driver_mod = importlib.import_module(f"{__package__}.traffic.{traffic['driver']}")
    cuda = torch.device(device).type == "cuda"
    tmp = tempfile.mkdtemp(prefix="portbench-")
    closers = []
    try:
        phases = {}
        pipe = weights.build_pipeline(cfg, seed, device, phases)
        t_weights = time.perf_counter()
        if fault is not None:
            fault(pipe)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        probe = Probe(pipe, spans=trace)
        closers.append(probe.close)
        ctx = Context(cfg=cfg, traffic=traffic, seed=seed, pipe=pipe, probe=probe,
                      rng=np.random.default_rng(seed), tmp=tmp)
        driver = driver_mod.Driver(ctx)
        driver.setup()
        t_warm = time.perf_counter()
        flops = bounds = None
        if trace:
            flops = family(cfg).model_flops(cfg)
            bounds = _bounds(pipe, cfg, device) if cuda else None
            driver.trace_spans(probe.spans)
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        # set-up's objects leave the collector's generations, so that its
        # passes in the window walk only what the window makes
        gc.collect()
        gc.freeze()
        try:
            with Trace(trace and cuda) as tr:
                record = driver.window(seconds)
        finally:
            gc.unfreeze()
        run = Run(record, setup_s, tr if trace and cuda else None, flops, bounds,
                  probe.decode_events, probe.spans or [])
        dev = device_info(device, cell["chips"])
        values = {}
        for m in cell_metrics(bench, cell, trace):
            v = metrics.reader(m["name"])(run, m["name"].partition(".")[2])
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        out = {"attempted": record.attempted, "failed": record.failed, "metrics": values,
               "device": dev}
        other = {m["name"]: metrics.reader(m["name"])(run, m["name"].partition(".")[2])
                 for m in cell_metrics(bench, cell, not trace) if m["name"] != "setup_s"}
        log(f"portbench: {record.attempted} attempted, {record.failed} failed, metrics "
            f"{json.dumps(values)} (and of the other trace mode {json.dumps(other)}), "
            f"memory peak {dev['memory_peak_bytes']}; set-up {setup_s:.2f} s: weights "
            f"{t_weights - t_start:.2f} ({json.dumps(phases)}), warm-up "
            f"{t_warm - t_weights:.2f}")
        if run.trace is not None:
            ends = [w["t1"] for w in map(record.window, record.windows) if w is not None]
            t1 = max(ends) if ends else time.perf_counter()
            busy = busy_us([(s, e) for _, s, e in run.trace.within(record.t0, t1)])
            dev.update(busy_s=busy, window_s=t1 - record.t0)
            out["breakdown"] = breakdown(run, record.t0, t1)
            log(f"portbench: trace read in {run.trace.read_s:.1f} s, "
                f"{len(run.trace.events)} device events")
        data = driver.collect()
        data["window_failed"] = record.failed
        driver.close()
        probe.close()
        del driver, ctx, probe, pipe, run
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        ref = weights.build_reference(cfg, seed, device)
        ref_view = check.reference_view(data, ref, cfg, device)
        del ref
        exact = check.integrity(data)
        found = {**check.numbers(check.program_view(data), ref_view, cfg), **exact}
        readings = {"program": found}
        if control:
            ref8 = weights.build_reference(cfg, seed, device, fp8=True)
            ctrl = check.reference_view(data, ref8, cfg, device, fp8=True)
            del ref8
            # the control in the program's place, judged by the same limits
            # and verdict as the program (its exact numbers are the run's)
            readings["control"] = check.numbers(ctrl, ref_view, cfg)
            out["control_correct"] = check.correct(
                check.judge({**readings["control"], **exact}, limits))
        log(f"portbench: output check took {time.perf_counter() - t_check:.1f} s over "
            f"{len(data['units'])} units")
        checks = check.judge(found, limits)
        out["correct"] = check.correct(checks)
        out["readings"] = readings
        out["checks"] = checks
        return out
    finally:
        for close in closers:
            close()
        shutil.rmtree(tmp, ignore_errors=True)

