"""The port's ``utils/{config,logging,profiling,plots}`` held against the JAX
package's modules of the same names: the same config tree and overlays
(dict equality), the same log line from the same record, the same phase
report shape, the same plot files from the same CSV. No wall-clock value is
asserted."""

import json
import logging
import os
import subprocess
import sys

import pytest
import torch

from dvdx_tpu.utils import config as jax_config
from dvdx_tpu.utils import logging as jax_logging
from dvdx_tpu.utils import plots as jax_plots
from dvdx_tpu.utils import profiling as jax_profiling
from dvdx_tpu_torch.utils import config, plots, profiling
from dvdx_tpu_torch.utils import logging as port_logging

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARGV = ["--diffusion.num_steps", "30", "--neuron.mock", "true", "--economics.audit_rate",
        "0.25", "--validator.atol", "0.01", "--neuron.name", "m7", "--unrelated", "x"]
ENV = {"DVDX_VALIDATOR_SAMPLE_SIZE": "5", "DVDX_NEURON_MOCK": "1",
       "DVDX_DIFFUSION_GUIDANCE_SCALE": "6.0", "DVDX_ECONOMICS_SLASH_FRACTION": "0.2"}


@pytest.mark.parametrize("overlay", ["defaults", "argv", "env", "env_then_argv"])
def test_config_to_dict_equals_jax(overlay, monkeypatch):
    if overlay.startswith("env"):
        for k, v in ENV.items():
            monkeypatch.setenv(k, v)
    argv = ARGV if overlay in ("argv", "env_then_argv") else []
    if overlay == "defaults":
        port, ref = config.DVDXConfig.default(), jax_config.DVDXConfig.default()
    else:
        port, ref = config.DVDXConfig.from_args(argv), jax_config.DVDXConfig.from_args(argv)
    assert port.to_dict() == ref.to_dict()
    if overlay == "argv":
        assert port.diffusion.num_steps == 30 and port.neuron.mock is True
        assert port.economics.audit_rate == 0.25
    if overlay == "env":
        assert port.validator.sample_size == 5 and port.diffusion.guidance_scale == 6.0


def test_config_json_round_trip_between_the_packages(tmp_path):
    """A file either package writes loads in the other to the same tree."""
    cfg = config.DVDXConfig.from_args(ARGV)
    cfg.save_json(str(tmp_path / "port.json"))
    assert jax_config.DVDXConfig.from_json(str(tmp_path / "port.json")).to_dict() == cfg.to_dict()
    ref = jax_config.DVDXConfig.from_args(["--validator.sample_size", "7"])
    ref.save_json(str(tmp_path / "jax.json"))
    assert config.DVDXConfig.from_json(str(tmp_path / "jax.json")).to_dict() == ref.to_dict()
    assert config.DVDXConfig.from_dict({"neuron": {"netuid": 3, "nope": 1}, "x": 2}
                                       ).neuron.netuid == 3


def test_setup_logging_formats_the_same_record(tmp_path):
    """The same record through each package's handlers gives the same line,
    the role tag, the EVENT level's name and the rotating file's name."""
    logger = logging.getLogger("dvdx")
    saved = (list(logger.handlers), logger.level)
    try:
        lines = []
        for mod, sub in ((jax_logging, "jax"), (port_logging, "port")):
            log = mod.setup_logging(role="miner", index=2, log_dir=str(tmp_path / sub))
            record = logging.LogRecord("dvdx.network", mod.EVENT_LEVEL, __file__, 1,
                                       "round %s settled", ("r1",), None)
            record.created, record.msecs = 1.7e9, 250.0
            handler = log.handlers[0]
            assert handler.filter(record)
            lines.append(handler.format(record))
            mod.event(log, "deposit %d", 5)
            for h in log.handlers:
                h.flush()
            assert os.listdir(tmp_path / sub) == ["miner2.log"]
            assert "| EVENT   | miner2 | dvdx | deposit 5" in (tmp_path / sub / "miner2.log").read_text()
        assert lines[0] == lines[1]
        assert "| EVENT   | miner2 | dvdx.network | round r1 settled" in lines[1]
        assert port_logging.EVENT_LEVEL == jax_logging.EVENT_LEVEL == 38
    finally:
        for h in logger.handlers:
            h.close()
        logger.handlers[:] = saved[0]
        logger.setLevel(saved[1])


def test_phase_timer_report_and_dump(tmp_path):
    """The report's shape is the JAX timer's: per phase total_s, count and
    max_s; ``block=True`` on a CPU device has nothing to wait for."""
    port, ref = profiling.PhaseTimer(device="cpu"), jax_profiling.PhaseTimer()
    for timer in (port, ref):
        for name in ("encode", "denoise", "denoise", "decode"):
            with timer.phase(name, block=name == "decode"):
                torch.ones(8).sum()
    rep, want = port.report(), ref.report()
    assert list(rep) == list(want) == ["encode", "denoise", "decode"]
    for name in rep:
        assert rep[name].keys() == want[name].keys() == {"total_s", "count", "max_s"}
        assert rep[name]["count"] == want[name]["count"]
        assert 0.0 <= rep[name]["max_s"] <= rep[name]["total_s"]
    port.dump(str(tmp_path / "phases.json"))
    assert json.loads((tmp_path / "phases.json").read_text()) == rep
    with pytest.raises(ValueError):
        with port.phase("failing"):
            raise ValueError("the phase is still counted")
    assert port.report()["failing"]["count"] == 1


def test_device_memory_on_the_cpu_is_zeros():
    got = profiling.device_memory("cpu")
    assert got == {"peak_mb": 0.0, "in_use_mb": 0.0, "limit_mb": 0.0}
    assert got.keys() == jax_profiling.device_memory().keys()


def test_trace_on_the_cpu_holds_its_annotation(tmp_path):
    """``trace`` writes one Chrome trace JSON into its directory, with the
    annotated range and the host ops inside it."""
    with profiling.trace(str(tmp_path / "trace"), device="cpu") as path:
        with profiling.annotate("unet_call"):
            x = torch.randn(32, 32)
            (x @ x).sum()
    assert os.listdir(tmp_path / "trace") == [os.path.basename(path)]
    events = json.loads(open(path).read())["traceEvents"]
    marks = [e for e in events if e.get("name") == "unet_call"]
    assert marks and marks[0].get("cat") == "user_annotation"
    start, end = marks[0]["ts"], marks[0]["ts"] + marks[0]["dur"]
    assert any(e.get("name") == "aten::matmul" and start <= e["ts"] <= end for e in events)


def _write_runner_csv(path):
    from dvdx_tpu_torch.parallel.runner import CSV_COLUMNS

    rows = []
    for mode, lat in (("single", 4.0), ("fsdp", 3.0), ("hybrid", 2.5), ("hybrid_ctx", 2.2)):
        for world in (1, 2, 4):
            row = dict.fromkeys(CSV_COLUMNS, "")
            row.update(mode=mode, world_size=world, emu="cpu", latency_s=lat / world,
                       throughput_fps=16 * world / lat, peak_mem_mb=100.0 * world,
                       param_mb_per_device=1000.0 / world, network_bytes=world * 1e6)
            rows.append(row)
    import csv

    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=CSV_COLUMNS)
        w.writeheader()
        w.writerows(rows)


def test_plot_all_writes_the_jax_file_names(tmp_path):
    """From one runner CSV (the empty temp_instab / flow_err columns are
    read as NaN and still plotted, as in the JAX package), both packages
    write the same PNG names; the fsdp-vs-hybrid figure too."""
    csv_path = str(tmp_path / "results.csv")
    _write_runner_csv(csv_path)
    port = plots.plot_all(csv_path, str(tmp_path / "port"))
    ref = jax_plots.plot_all(csv_path, str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in port] == [os.path.basename(p) for p in ref]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert all(os.path.getsize(p) > 0 for p in port)
    out = plots.plot_fsdp_vs_hybrid(csv_path, str(tmp_path / "cmp" / "fsdp_vs_hybrid.png"))
    assert os.path.getsize(out) > 0
    assert list(plots.load_results(csv_path).columns) == list(
        jax_plots.load_results(csv_path).columns)


def test_plots_import_without_pandas_and_matplotlib(tmp_path):
    """As on the card's machine: the module imports, a plot raises an
    ImportError that names the missing package."""
    code = ("import sys\n"
            "sys.modules['pandas'] = None\n"
            "sys.modules['matplotlib'] = None\n"
            "from dvdx_tpu_torch.utils import plots\n"
            "try:\n"
            f"    plots.plot_all({str(tmp_path / 'none.csv')!r}, {str(tmp_path)!r})\n"
            "except ImportError as e:\n"
            "    print('ImportError', e)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                          capture_output=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ImportError") and "pandas" in proc.stdout
