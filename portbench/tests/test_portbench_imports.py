"""What the benchmark runs loads neither JAX nor the JAX package, and reads
none of the older benchmarks; its reference loads nothing of the program.
Each check runs in a fresh interpreter, so what the test runner imported
does not count; top-level module names are compared whole, since the
program's package name begins with the JAX package's."""

import json
import subprocess
import sys

from portbench.tests.conftest import ROOT

BANNED = ("jax", "jaxlib", "flax", "orbax", "dvdx_tpu")

_TINY_RUN = """
import json, sys
from portbench.tests.conftest import run_tiny
seen = []
sys.addaudithook(lambda ev, args: seen.append(str(args[0])) if ev == "open" else None)
out = run_tiny("mine")
names = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps({"modules": names, "opened": seen, "correct": out["correct"]}))
"""

_REFERENCE = """
import json, sys
import portbench.reference.torch_ref, portbench.reference.clip_text
import portbench.reference.noise, portbench.reference.merkle
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _python(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_reads_no_older_benchmark():
    got = _python(_TINY_RUN)
    assert got["correct"]
    assert "dvdx_tpu_torch" in got["modules"]
    assert not set(BANNED) & set(got["modules"])
    old = [p for p in got["opened"]
           if p.endswith(("chip_smoke.py", "/bench.py")) or "/benchmarks/" in p]
    assert not old


def test_the_reference_loads_nothing_of_the_program():
    names = _python(_REFERENCE)
    assert not {"dvdx_tpu_torch", *BANNED} & set(names)


def test_run_refuses_without_a_card():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "576w.mine",
                          "--seed", "2147483648", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
