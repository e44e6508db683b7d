"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, traffic mix, limits file and metric reader found by name."""

import importlib
import json
import os
import re

import pytest

from portbench import families, harness, metrics
from portbench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FAMILY_API = ("reference_modules", "spread", "empty_pipeline", "load", "text_states",
              "base_latent", "denoise", "update", "decode", "bound_calls", "model_flops")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert all(not p.startswith("/") and ".." not in p and not p.endswith("_torch")
               for p in bench["paths"])
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_keys(bench):
    entries = bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


@pytest.mark.parametrize("group", ["workloads", "configs"])
def test_every_entry_is_used_and_found(bench, group):
    used = {w["config"] for w in bench["workloads"]}
    for e in bench[group]:
        if group == "configs":
            assert e["name"] in used
            cfg = harness.load_json(os.path.join(ROOT, e["file"]))
            assert cfg["name"] == e["name"] and cfg["source"] == e["source"]
            assert cfg["reduced"] == e["reduced"]
            fam = families.family(cfg)
            assert all(callable(getattr(fam, f)) for f in FAMILY_API), cfg["family"]
            continue
        cfg, traffic = harness.cell_files(bench, e, ROOT)
        assert e["chips"] in (1, 4)
        driver = importlib.import_module(f"portbench.traffic.{traffic['driver']}")
        assert hasattr(driver, "Driver")
        assert harness.cell_limits(e)


def test_every_metric_has_a_reader_and_each_cell_reports_enough(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(metrics.reader(m["name"]))
    for w in bench["workloads"]:
        e2e = [m["name"] for m in harness.cell_metrics(bench, w, trace=False)]
        layer = harness.cell_metrics(bench, w, trace=True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in layer:  # what a per-layer metric moves, the cell reports
            assert m["moves"] in e2e


def test_per_layer_suffix_names_a_window(bench):
    for m in bench["per_layer"]:
        _, _, suffix = m["name"].partition(".")
        for name in m.get("workloads", [w["name"] for w in bench["workloads"]]):
            cell = next(w for w in bench["workloads"] if w["name"] == name)
            _, traffic = harness.cell_files(bench, cell, ROOT)
            driver = importlib.import_module(f"portbench.traffic.{traffic['driver']}")
            assert suffix in driver.Driver.WINDOWS, (m["name"], name)
