"""Where a benchmark cell's time goes by the program's own spans, and what a
span costs.

    python3 scripts/span_report.py --workload 576w.mine --seed 7 --seconds 51
    python3 scripts/span_report.py --cost

The first form runs one traced cell of ``portbench`` (``--trace 1``, on a
CUDA card, from the root of a checkout), prints the harness's result line,
and then one JSON line that reads the cell's window (the one its
``step_idle_pct`` metric is taken over) as the benchmark's readers do, from
the run's record, its device trace and the spans that
``dvdx_tpu_torch.utils.profiling`` recorded:

* ``idle_by_span``: the device's idle seconds, each idle stretch named by the
  innermost program span open over it (``(no span)`` where none was);
  ``idle_root_share``: the share of idle seconds under a root span
  (``miner.request``, ``audit``'s root ``validator.verify`` or ``audit``)
  or no span at all;
* ``step_ms``: host milliseconds a denoise step, by part: each UNet level's
  span (a DiT's ``dit`` span), the UNet call's own rest, the guidance's
  scalar upload, the DDIM update, and the step's rest;
* ``dit_ms``: for a DiT (``cogvideox.mine``), host milliseconds a ``dit``
  call by part: ``dit.embed``, the blocks' ``dit.attn`` and ``dit.ff``
  summed over the blocks, the blocks' own rest, ``dit.out`` and the call's
  rest;
* ``spans``: the count of spans by name, and spans per unit completed.

``--cost`` times ``span`` on this host: off, off filling a timings dict, on
(``recording()``), and on under a ``torch.profiler`` session of host
activity, where each span also enters a ``record_function`` range.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
import types

ROOTS = ("miner.request", "validator.verify", "audit")


def step_parts(spans):
    """Mean host milliseconds a ``denoise_step`` by part, over the whole
    steps of ``spans`` (``portbench.spans.Span``)."""
    kids = collections.defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    steps = [s for s in spans if s.name == "denoise_step"]
    parts = collections.Counter()
    for step in steps:
        rest = 1e3 * (step.end - step.start)
        for c in kids[step.id]:
            ms = 1e3 * (c.end - c.start)
            rest -= ms
            if c.name == "unet":
                for level in kids[c.id]:
                    parts[level.name] += 1e3 * (level.end - level.start)
                    ms -= 1e3 * (level.end - level.start)
                parts["unet (rest)"] += ms
            else:
                parts[c.name] += ms
        parts["denoise_step (rest)"] += rest
    n = len(steps)
    return {"steps": n, **{k: v / n for k, v in sorted(parts.items())}} if n else {"steps": 0}


def dit_parts(spans):
    """Mean host milliseconds a ``dit`` call by part, over the whole calls of
    ``spans``: its direct children by name (the blocks summed), the blocks'
    own children summed over the blocks, each parent's rest."""
    kids = collections.defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    calls = [s for s in spans if s.name == "dit"]
    parts = collections.Counter()
    for call in calls:
        rest = 1e3 * (call.end - call.start)
        for c in kids[call.id]:
            ms = 1e3 * (c.end - c.start)
            rest -= ms
            for g in kids[c.id]:
                parts[g.name] += 1e3 * (g.end - g.start)
                ms -= 1e3 * (g.end - g.start)
            parts[f"{c.name} (rest)" if kids[c.id] else c.name] += ms
        parts["dit (rest)"] += rest
    n = len(calls)
    return {"calls": n, **{k: v / n for k, v in sorted(parts.items())}} if n else {"calls": 0}


def read_window(run, suffix: str) -> dict:
    from portbench.metrics import window
    from portbench.spans import idle_by_innermost, window_spans

    w = window(run, suffix)
    spans = window_spans(w)
    if run.trace is None or not spans:
        return {"error": "no traced window or no spans in it"}
    t0, t1 = w["t0"], w["t1"]
    device = [(s, e) for _, s, e in run.trace.within(t0, t1)]
    by_span = idle_by_innermost(spans, device, t0, t1)
    idle_s = sum(by_span.values())
    rooted = sum(v for k, v in by_span.items() if k is None or k in ROOTS)
    units = sum(u.ok for u in w["units"])
    whole = [s for s in spans if s.start > t0 and s.end < t1]
    return {"window": suffix, "window_s": t1 - t0, "idle_s": idle_s,
            "idle_root_share": rooted / idle_s if idle_s else None,
            "idle_by_span": {k or "(no span)": v for k, v in by_span.items()},
            "step_ms": step_parts(whole),
            "dit_ms": dit_parts(whole),
            "spans": {"total": len(spans), "units": units,
                      "per_unit": len(spans) / units if units else None,
                      "by_name": dict(collections.Counter(s.name for s in spans)
                                      .most_common())}}


def report(workload: str, seed: int, seconds: float) -> dict:
    """One traced run of ``workload``; the window is read by a reader the
    harness finds by its family's name, as it finds the benchmark's own."""
    import torch

    from portbench.harness import run_cell

    with open("BENCHMARK.json") as f:
        bench = json.load(f)
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    suffix = next(m["name"].partition(".")[2] for m in bench["per_layer"]
                  if m["name"].startswith("step_idle_pct.") and workload in m["workloads"])
    found = {}

    def read(run, suffix):
        found.update(read_window(run, suffix))
        return None

    sys.modules["portbench.metrics.span_report"] = types.SimpleNamespace(read=read)
    bench["per_layer"] = bench["per_layer"] + [
        {"name": f"span_report.{suffix}", "workloads": [workload]}]
    out = run_cell(bench, cell, seed, seconds, True, "cuda", time.perf_counter(),
                   root=os.getcwd(), log=lambda s: print(s, file=sys.stderr, flush=True))
    out.pop("readings")
    print(json.dumps(out), flush=True)
    return {"workload": workload, "seed": seed, "correct": out["correct"],
            "card": torch.cuda.get_device_name(0), **found}


def cost(n: int = 200_000) -> dict:
    import torch

    from dvdx_tpu_torch.utils.profiling import recording, span

    def timed(fn):
        best = float("inf")
        for _ in range(5):
            t = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t)
        return 1e9 * best / n

    def empty():
        for i in range(n):
            pass

    def off():
        for i in range(n):
            with span("unet.mid"):
                pass

    def off_timings():
        d = {}
        for i in range(n):
            with span("dispatch_loop", d):
                pass

    base = timed(empty)
    out = {"n": n, "loop_ns": base, "off_ns": timed(off) - base,
           "off_timings_ns": timed(off_timings) - base}
    with recording():
        out["on_ns"] = timed(off) - base
    n_prof = n // 10
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t = time.perf_counter()
        for i in range(n_prof):
            with span("denoise_step"):
                pass
        out["on_profiled_ns"] = 1e9 * (time.perf_counter() - t) / n_prof - base
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=2147483001)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--cost", action="store_true")
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    out = cost() if args.cost else report(args.workload, args.seed, args.seconds)
    print("span_report " + json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
