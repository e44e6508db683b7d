"""The readers of the program's own spans: ``step_host_ms``, ``sync_ms`` and
``step_idle_pct`` on a fabricated window whose spans and device intervals
overlap by known amounts; None from a program without the span recorder;
and on a tiny CPU run of each traffic mix inside ``profiling.recording()``
(no device trace there, so ``step_idle_pct`` reads None)."""

import time
import types

import pytest

from dvdx_tpu_torch.utils import profiling
from portbench import metrics
from portbench.tests.conftest import ROOT, TINY_LIMITS, tiny_bench
from portbench.trace import Trace

NEW = ("step_host_ms", "sync_ms", "step_idle_pct")


def fabricated(monkeypatch, trace=True):
    """A window [10, 20] s with two whole denoise steps (the first with a
    0.2 s wait inside it), one cut by the window's end, a 0.5 s wait
    outside the steps, and device intervals partly under the steps."""
    s = 10 ** 9

    def sp(name, a, b, i, parent):
        return profiling.Span(name, int(a * s), int(b * s), i, parent)

    recorded = [sp("miner.request", 10.5, 15.0, 1, 0),
                sp("denoise_step", 11.0, 12.0, 2, 1),
                sp("unet", 11.0, 11.5, 3, 2),
                sp("wait.step_fetch", 11.5, 11.7, 4, 2),
                sp("denoise_step", 12.0, 13.5, 5, 1),
                sp("wait.compute", 14.0, 14.5, 6, 1),
                sp("denoise_step", 19.5, 20.5, 7, 0),
                sp("denoise_step", 25.0, 26.0, 8, 0)]
    monkeypatch.setattr(profiling, "spans", lambda: list(recorded))
    tr = None
    if trace:
        tr = Trace(False)
        tr.events = [("k", 11.2, 11.4), ("k", 12.0, 13.0), ("k", 19.8, 20.2), ("k", 30.0, 31.0)]
    units = [types.SimpleNamespace(ok=True), types.SimpleNamespace(ok=True)]
    w = {"t0": 10.0, "t1": 20.0, "units": units}
    return types.SimpleNamespace(record=types.SimpleNamespace(window=lambda name: w), trace=tr)


def read(run, name):
    return metrics.reader(name)(run, name.partition(".")[2])


def test_readers_on_a_fabricated_window(monkeypatch):
    run = fabricated(monkeypatch)
    # the two whole steps: 1.0 s less its 0.2 s wait, and 1.5 s
    assert read(run, "step_host_ms.video") == pytest.approx(1150.0)
    # 0.2 + 0.5 s of waits over 2 units
    assert read(run, "sync_ms.video") == pytest.approx(350.0)
    # steps cover [11, 13.5] and [19.5, 20] of the window; the device ran
    # 0.2 + 1.0 + 0.2 s of it
    assert read(run, "step_idle_pct.video") == pytest.approx(16.0)


def test_idle_by_innermost_span_on_a_fabricated_window(monkeypatch):
    from portbench.spans import idle_by_innermost, window_spans

    run = fabricated(monkeypatch)
    w = run.record.window("video")
    device = [(s, e) for _, s, e in run.trace.within(w["t0"], w["t1"])]
    got = idle_by_innermost(window_spans(w), device, w["t0"], w["t1"])
    # idle [10, 11.2], [11.4, 12], [13, 19.8], each stretch by the span
    # that started last of those open over it
    want = {None: 0.5 + 4.5, "miner.request": 0.5 + 0.5 + 0.5, "denoise_step": 0.3 + 0.5 + 0.3,
            "unet": 0.2 + 0.1, "wait.step_fetch": 0.2, "wait.compute": 0.5}
    assert got == pytest.approx(want)
    assert list(got)[0] is None and sum(got.values()) == pytest.approx(8.6)


def test_readers_find_nothing_without_the_recorder_or_the_trace(monkeypatch):
    assert read(fabricated(monkeypatch, trace=False), "step_idle_pct.video") is None
    monkeypatch.delattr(profiling, "spans")
    run = types.SimpleNamespace(
        record=types.SimpleNamespace(window=lambda name: {"t0": 0.0, "t1": 1.0, "units": []}),
        trace=Trace(False))
    for family in NEW:
        assert read(run, f"{family}.video") is None


@pytest.mark.parametrize("traffic,window", [("mine", "video"), ("audit", "audit")])
def test_readers_on_a_tiny_cpu_run(traffic, window):
    from portbench.harness import run_cell

    bench, cell = tiny_bench(traffic)
    bench["per_layer"] = [{"name": f"{family}.{window}", "unit": "ms",
                           "workloads": [cell["name"]]} for family in NEW]
    limits = dict(TINY_LIMITS, **({"leaves": 0} if traffic == "mine"
                                  else {"proofs": 0, "verdicts": 0}))
    with profiling.recording():
        out = run_cell(bench, cell, 20260502, 5.0, True, "cpu", time.perf_counter(),
                       root=ROOT, limits=limits, log=lambda s: None)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert got[f"step_host_ms.{window}"]["value"] > 0.0
    assert got[f"sync_ms.{window}"]["value"] >= 0.0
    assert f"step_idle_pct.{window}" not in got
