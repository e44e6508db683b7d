"""The control on the card: each cell's run at its own size with the float8
reference read in the program's place after the window. The program must
come out correct, and the control, judged by the same limits and the same
verdict (``check.judge`` and ``check.correct``), not correct.
Needs a CUDA card; run on one with ``python -m pytest portbench/tests -m
cuda``."""

import json
import subprocess
import sys

import pytest

from portbench.harness import cell_limits
from portbench.tests.conftest import ROOT

SEEDS = (2147483901, 2147483902, 2147483903)
SECONDS = {"576w.mine": 12, "xl.mine": 30, "576w.audit": 12}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SECONDS))
def test_control_fails_and_program_passes(bench, cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limits = cell_limits(next(w for w in bench["workloads"] if w["name"] == cell))
    for seed in SEEDS:
        out = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload", cell, "--seed", str(seed),
             "--seconds", str(SECONDS[cell]), "--trace", "0", "--control", "1"],
            cwd=ROOT, capture_output=True, text=True, timeout=900, check=True)
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"], line["checks"]
        got = [ln for ln in out.stderr.splitlines() if ln.startswith("portbench readings ")]
        control = json.loads(got[-1].split(" ", 2)[2])["control"]
        assert line["control_correct"] is False, (control, limits)
