"""Import hygiene of the PyTorch port: every ``dvdx_tpu_torch`` module, and
what ``chip_smoke.py`` imports, must import with JAX, flax, ml_dtypes and the
JAX package blocked (``sys.modules[name] = None`` makes any import of them
fail), and no source of the package names them."""

import os
import pathlib
import pkgutil
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "ml_dtypes", "dvdx_tpu"):
    sys.modules[name] = None
import dvdx_tpu_torch
mods = sorted(m.name for m in pkgutil.walk_packages(dvdx_tpu_torch.__path__,
                                                    "dvdx_tpu_torch."))
for m in mods:
    importlib.import_module(m)
print(len(mods))
"""


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                          capture_output=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": REPO})


def test_port_imports_without_jax():
    proc = _run(_BLOCKED_IMPORT)
    assert proc.returncode == 0, proc.stderr
    import dvdx_tpu_torch

    expected = sum(1 for _ in pkgutil.walk_packages(dvdx_tpu_torch.__path__,
                                                    "dvdx_tpu_torch."))
    assert int(proc.stdout.split()[-1]) == expected >= 15


def test_chip_smoke_imports_without_jax():
    """chip_smoke.py's module-level imports and the port modules its phases
    import; without a card ``main`` stops before any phase and exits 2."""
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'flax', 'ml_dtypes', 'dvdx_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import runpy\n"
            "g = runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
            "assert set(g['read_counts']()) == set(g['KERNEL_META'])\n"
            "import dvdx_tpu_torch.pipelines.text2video, dvdx_tpu_torch.verify.merkle\n"
            "import dvdx_tpu_torch.verify.spotcheck\n"
            "import dvdx_tpu_torch.network.mock, dvdx_tpu_torch.network.validator\n"
            "import dvdx_tpu_torch.utils.testing\n"
            "from dvdx_tpu_torch.ops.groupnorm import group_norm_moments, group_norm_apply\n"
            "from dvdx_tpu_torch.pipelines.text2video import param_cache_path\n"
            "from dvdx_tpu_torch.utils.checkpoint import save_params\n"
            "import torch\n"
            "assert torch.cuda.is_available() or g['main']() == 2\n"
            "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("source", ["flash_attention", "temporal_attention",
                                    "geglu_ff", "groupnorm", "spatial_tail",
                                    "temporal_block", "attention_f32",
                                    "spatial_tail_f32", "temporal_block_f32",
                                    "bias_epilogue", "qk_norm_rope", "dit_epilogue"])
def test_kernel_sources_ship(source):
    """Every CUDA source the build compiles exists in the package, beside the
    shared header."""
    from dvdx_tpu_torch.ops import _build

    assert source in _build.SOURCES
    assert (_build.CSRC / f"{source}.cu").is_file()
    assert (_build.CSRC / "common.cuh").is_file()


@pytest.mark.parametrize("module", [
    "network.protocol", "network.base", "network.ledger", "network.transport",
    "network.miner", "network.validator", "network.mock", "scoring.common",
    "scoring.mdvqs", "scoring.clip_score", "models.clip_vision", "utils.video_io",
    "verify.proof", "models.tokenizer", "utils.convert", "pipelines.text2video",
    "__main__", "network.api", "network.chain", "network.deposit_listener",
    "network.http_transport", "network.services", "scoring.lpips", "utils.keccak",
    "utils.bridge", "economics.params", "economics.security", "economics.cost",
    "economics.optimize", "models.dit_video", "models.vae", "models.zoo",
    "pipelines.img2video", "ops.scheduler", "ops.rng", "parallel.chunking",
    "parallel.latent_chunking", "parallel.mesh", "parallel.sharding",
    "parallel.strategies", "parallel.runner", "parallel.coordinator",
    "parallel.worker", "ops.ring_attention", "ops.attention", "ops.groupnorm",
    "scoring.temporal", "verify.spotcheck", "utils.native", "utils.profiling",
    "utils.config", "utils.logging", "utils.plots", "verify.merkle"])
def test_network_and_scoring_modules_import_without_jax(module):
    proc = _run("import sys\n"
                "for name in ('jax', 'jaxlib', 'flax', 'ml_dtypes', 'dvdx_tpu'):\n"
                "    sys.modules[name] = None\n"
                f"import dvdx_tpu_torch.{module}\n"
                "print('ok')\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_no_source_names_jax_or_the_jax_package():
    """No source of the port, nor chip_smoke.py, imports jax, flax or
    ml_dtypes, or names a module of the JAX package as ``dvdx_tpu.<name>``."""
    imports = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|ml_dtypes|dvdx_tpu)\b")
    offenders = []
    sources = sorted(pathlib.Path(REPO, "dvdx_tpu_torch").rglob("*.py"))
    for path in sources + [pathlib.Path(REPO, "chip_smoke.py")]:
        for line in path.read_text().splitlines():
            if imports.search(line) or re.search(r"\bdvdx_tpu\.", line) \
                    or "import jax" in line:
                offenders.append(f"{path.name}: {line.strip()}")
    assert not offenders, offenders
    assert len(sources) >= 30
