"""Shared fixtures of the benchmark's own tests: the repository's
``BENCHMARK.json`` and a small cell of ``zeroscope-tiny-hf`` widths
(``tiny.json``) that the harness runs on the CPU."""

import json
import os
import time

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

# program f32 against the reference at the tiny widths: the latents are
# bf16 (the configurations' latent dtype), so the noise, UNet outputs and
# DDIM updates carry bf16 rounding (half an ulp is 0.0156 at |z| >= 4, and
# a late step's z_{t+1} can have an RMS under 1); text states and frames
# float32 rounding
TINY_LIMITS = {"text_rms": 1e-4, "noise_max": 0.02, "unet_rms": 5e-3, "eps_rms": 0.05,
               "ddim_max": 0.05, "frames_rms": 1e-4}


@pytest.fixture(scope="session")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_bench(traffic: str):
    cell = {"name": f"tiny.{traffic}", "config": "tiny", "traffic": traffic, "chips": 1}
    bench = {"configs": [{"name": "tiny", "file": os.path.join(HERE, "tiny.json")}],
             "end_to_end": [{"name": "setup_s", "unit": "s"},
                            {"name": "video_s", "unit": "s", "workloads": ["tiny.mine"]},
                            {"name": "step_s", "unit": "s", "workloads": ["tiny.mine"]},
                            {"name": "audit_s", "unit": "s", "workloads": ["tiny.audit"]}],
             "per_layer": []}
    return bench, cell


def run_tiny(traffic: str, seed: int = 20260501, seconds: float = 5.0, fault=None,
             control: bool = False):
    """One CPU run of the tiny cell; returns the harness's result. The
    window is long enough that the first request or audit, which the check
    reads, completes on a loaded CPU."""
    from portbench.harness import run_cell

    bench, cell = tiny_bench(traffic)
    limits = dict(TINY_LIMITS, **({"leaves": 0} if traffic == "mine"
                                  else {"proofs": 0, "verdicts": 0}))
    return run_cell(bench, cell, seed, seconds, False, "cpu", time.perf_counter(), root=ROOT,
                    control=control, limits=limits, fault=fault, log=lambda s: None)
