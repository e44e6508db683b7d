"""``utils.checkpoint``: the port reads what the JAX package's ``save_params``
writes, and writes what the JAX package's ``load_params`` reads, without JAX
or orbax, bit for bit (tolerance 0), and fetches with retries.

* ``save_params`` (orbax) into ``tmp_path``, then the port's ``load_params``:
  every leaf bit-equal, float32 and bfloat16, loaded strictly into a
  pipeline or returned as a tree;
* the committed fixture ``tests/data/zeroscope_tiny_p99_orbax`` (the JAX
  package's zeroscope-tiny, seed 0, perturbed at seed 99, written by
  ``save_params``; ``python tests/test_torch_checkpoint.py`` writes it
  again) is what the JAX package reads back as that model, and what the
  port's ``fast_init`` + ``perturb_zero_params`` give;
* the port's ``save_params`` / ``save_pipeline`` restored by the JAX
  package's ``load_params`` bit for bit (float32 and bfloat16), with the
  fixture's tree metadata, and by the port's own reader; without
  ``tensorstore`` both directions raise ``ImportError`` naming it;
* other checkpoint layouts are refused; the reader imports with JAX, flax,
  orbax and the JAX package blocked;
* ``fetch_checkpoint`` retries with backoff (fetcher replaced,
  ``backoff_s=0``), and ``hf://`` sources are parsed (the network call
  replaced: nothing is downloaded);
* the services take ``--params-ckpt`` instead of ``--perturb``, as the
  JAX services do.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvdx_tpu.pipelines.text2video import build_pipeline as jbuild
from dvdx_tpu.utils import checkpoint as jckpt
from dvdx_tpu.utils.testing import perturb_zero_params as jperturb
from dvdx_tpu_torch.models.zoo import get_model_spec
from dvdx_tpu_torch.network import services
from dvdx_tpu_torch.pipelines.text2video import build_pipeline, empty_pipeline
from dvdx_tpu_torch.utils import checkpoint
from dvdx_tpu_torch.utils.init import tree_digest
from dvdx_tpu_torch.utils.testing import perturb_zero_params
from tests.test_torch_init import _bf16_spec, _bits, differing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "zeroscope_tiny_p99_orbax")


def _jax_tiny(dtype=None):
    pipe = jbuild("zeroscope-tiny", seed=0, params_dtype=dtype)
    pipe.params = jperturb(pipe.params, seed=99)
    return pipe


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_params_reads_save_params_bitwise(tmp_path, dtype):
    ref = _jax_tiny(None if dtype == "float32" else jnp.bfloat16)
    jckpt.save_params(ref.params, str(tmp_path / "ckpt"))
    spec = get_model_spec("zeroscope-tiny") if dtype == "float32" \
        else _bf16_spec("zeroscope-tiny")
    pipe = checkpoint.load_params(str(tmp_path / "ckpt"), like=empty_pipeline(spec, "cpu"))
    assert next(pipe.unet.parameters()).dtype == getattr(torch, dtype)
    assert differing(ref.params, pipe) == []
    tree = checkpoint.load_params(str(tmp_path / "ckpt"))
    want = {tuple(k.key for k in p): v for p, v in
            jax.tree_util.tree_flatten_with_path(ref.params)[0]}
    got = {}

    def walk(node, path=()):
        for k, v in node.items():
            walk(v, path + (k,)) if isinstance(v, dict) else got.__setitem__(path + (k,), v)

    walk(tree)
    assert set(got) == set(want)
    for path, v in got.items():
        assert v.dtype == getattr(torch, dtype), path
        np.testing.assert_array_equal(_bits(v), _bits(np.asarray(want[path])), err_msg=str(path))


def test_fixture_is_the_jax_packages_save_params_of_the_tiny_model():
    ref = _jax_tiny()
    back = jckpt.load_params(FIXTURE, like=ref.params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref.params)):
        np.testing.assert_array_equal(_bits(np.asarray(a)), _bits(np.asarray(b)))


def test_fixture_equals_the_ports_own_weights():
    own = perturb_zero_params(build_pipeline("zeroscope-tiny", seed=0, device="cpu"), seed=99)
    loaded = checkpoint.load_pipeline("zeroscope-tiny", FIXTURE, device="cpu")
    assert tree_digest(loaded) == tree_digest(own)


def test_load_is_strict(tmp_path):
    ref = _jax_tiny()
    del ref.params["vae_dec"]
    jckpt.save_params(ref.params, str(tmp_path / "ckpt"))
    with pytest.raises(KeyError, match="tree names"):
        checkpoint.load_params(str(tmp_path / "ckpt"),
                               like=empty_pipeline(get_model_spec("zeroscope-tiny"), "cpu"))
    with pytest.raises(KeyError, match="no such module"):  # another model's tree
        checkpoint.load_params(FIXTURE, like=empty_pipeline(get_model_spec("zeroscope-tiny-hf"),
                                                            "cpu"))


@pytest.mark.parametrize("change", [{"use_zarr3": True}, {"use_ocdbt": False}, None])
def test_other_layouts_are_refused(tmp_path, change):
    d = tmp_path / "ckpt"
    shutil.copytree(FIXTURE, d)
    if change is None:
        os.unlink(d / "_METADATA")
        match = "_METADATA"
    else:
        meta = json.loads((d / "_METADATA").read_text())
        meta.update(change)
        (d / "_METADATA").write_text(json.dumps(meta))
        match = "use_ocdbt"
    with pytest.raises(checkpoint.CheckpointFormatError, match=match):
        checkpoint.load_params(str(d))


def test_reads_without_jax_or_orbax():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'flax', 'orbax', 'dvdx_tpu'):\n"
            "    sys.modules[name] = None\n"
            "from dvdx_tpu_torch.utils.checkpoint import load_pipeline\n"
            "from dvdx_tpu_torch.utils.init import tree_digest\n"
            f"print(tree_digest(load_pipeline('zeroscope-tiny', {FIXTURE!r}, device='cpu')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    own = perturb_zero_params(build_pipeline("zeroscope-tiny", seed=0, device="cpu"), seed=99)
    assert proc.stdout.split()[-1] == tree_digest(own)


def test_no_port_source_imports_orbax_or_tensorstore_at_module_level():
    import pathlib
    import re

    bad = []
    for path in sorted(pathlib.Path(REPO, "dvdx_tpu_torch").rglob("*.py")):
        for line in path.read_text().splitlines():
            if re.match(r"^(import|from)\s+(orbax|tensorstore|ml_dtypes)\b", line):
                bad.append(f"{path.name}: {line}")
    assert not bad, bad


# --- save_params: the port writes what the JAX package reads -----------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_load_params_restores_the_ports_save_params(tmp_path, dtype):
    """The port's ``save_params`` of its zeroscope-tiny (seed 0, perturbed at
    99) restored by the JAX package's ``load_params(path, like=...)``: the
    JAX tree's paths, order, shapes, dtypes and every bit; read back by the
    port's ``load_params`` (into a pipeline and as a tree) the same."""
    spec = get_model_spec("zeroscope-tiny") if dtype == "float32" \
        else _bf16_spec("zeroscope-tiny")
    port = perturb_zero_params(build_pipeline(spec, seed=0, device="cpu"), seed=99)
    path = str(tmp_path / "ckpt")
    checkpoint.save_params(port, path)
    ref = _jax_tiny(None if dtype == "float32" else jnp.bfloat16)
    back = jckpt.load_params(path, like=ref.params)
    assert differing(back, port) == []
    assert all(np.asarray(a).dtype == np.asarray(b).dtype
               for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref.params)))
    again = checkpoint.load_params(path, like=empty_pipeline(spec, "cpu"))
    assert tree_digest(again) == tree_digest(port)
    tree = checkpoint.load_params(path)
    assert sorted(tree) == ["text", "unet", "vae_dec"]
    checkpoint.save_pipeline(port, path)  # replaces the directory
    assert tree_digest(checkpoint.load_params(path, like=empty_pipeline(spec, "cpu"))) == \
        tree_digest(port)


def test_save_params_of_the_fixture_model_reads_as_the_fixture(tmp_path):
    """The port's save of the fixture's model and the JAX package's fixture
    hold the same tree: the same _METADATA leaves and the same values."""
    own = perturb_zero_params(build_pipeline("zeroscope-tiny", seed=0, device="cpu"), seed=99)
    checkpoint.save_params(own, str(tmp_path / "ckpt"))
    meta = [json.loads((p / "_METADATA").read_text())["tree_metadata"]
            for p in (tmp_path / "ckpt", __import__("pathlib").Path(FIXTURE))]
    assert meta[0] == meta[1]
    mine = checkpoint.load_pipeline("zeroscope-tiny", str(tmp_path / "ckpt"), device="cpu")
    assert tree_digest(mine) == tree_digest(checkpoint.load_pipeline("zeroscope-tiny",
                                                                    FIXTURE, "cpu"))


def test_save_params_without_tensorstore_raises(tmp_path, monkeypatch):
    """Where tensorstore does not import (the card's host) writing raises
    ImportError naming it, as reading does, and writes nothing."""
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    pipe = build_pipeline("zeroscope-tiny", seed=0, device="cpu")
    with pytest.raises(ImportError, match="tensorstore"):
        checkpoint.save_params(pipe, str(tmp_path / "ckpt"))
    with pytest.raises(ImportError, match="tensorstore"):
        checkpoint.load_params(FIXTURE)
    assert not (tmp_path / "ckpt").exists()


# --- fetch ------------------------------------------------------------------------


def test_fetch_retries_with_backoff(tmp_path, monkeypatch):
    calls, sleeps = [], []
    monkeypatch.setattr(checkpoint.time, "sleep", sleeps.append)

    def flaky(src, dst):
        calls.append((src, dst))
        if len(calls) < 3:
            raise OSError("transient")
        os.makedirs(dst)

    dst = str(tmp_path / "out")
    assert checkpoint.fetch_checkpoint("src", dst, retries=5, backoff_s=0.5, fetcher=flaky) == dst
    assert len(calls) == 3 and sleeps == [0.5, 1.0] and os.path.isdir(dst)


def test_fetch_gives_up_after_its_retries(tmp_path):
    calls = []

    def broken(src, dst):
        calls.append(1)
        raise OSError("down")

    with pytest.raises(RuntimeError, match="after 3 attempts: down"):
        checkpoint.fetch_checkpoint("src", str(tmp_path / "x"), retries=3, backoff_s=0,
                                    fetcher=broken)
    assert len(calls) == 3


def test_fetch_copies_a_local_directory(tmp_path):
    dst = tmp_path / "copy"
    dst.mkdir()
    (dst / "stale").write_text("x")
    checkpoint.fetch_checkpoint(FIXTURE, str(dst), backoff_s=0)
    assert not (dst / "stale").exists()
    assert tree_digest(checkpoint.load_pipeline("zeroscope-tiny", str(dst), "cpu")) == \
        tree_digest(checkpoint.load_pipeline("zeroscope-tiny", FIXTURE, "cpu"))


@pytest.mark.parametrize("src,repo_id,revision", [
    ("hf://org/name", "org/name", None), ("hf://org/name@v1.2", "org/name", "v1.2")])
def test_hf_sources_are_parsed(tmp_path, monkeypatch, src, repo_id, revision):
    seen, fails = [], []

    def snapshot(rid, rev, dst):
        seen.append((rid, rev, dst))
        if not fails:
            fails.append(1)
            raise ConnectionError("first attempt")

    monkeypatch.setattr(checkpoint, "_hf_snapshot", snapshot)
    dst = str(tmp_path / "snap")
    assert checkpoint.fetch_checkpoint(src, dst, backoff_s=0) == dst
    assert seen == [(repo_id, revision, dst)] * 2 and os.path.isdir(dst)


@pytest.mark.parametrize("src", ["hf://noslash", "hf://a/b/c", "hf://"])
def test_bad_hf_sources_raise(src):
    with pytest.raises(ValueError, match="bad hf source"):
        checkpoint.hf_fetcher(src)


# --- the services ------------------------------------------------------------------


def test_services_take_the_checkpoint_instead_of_the_perturbation(monkeypatch):
    """``--params-ckpt`` replaces the weights and ``--perturb`` then does
    nothing (the JAX services' ``elif``); a registry name's modules are then
    filled from the checkpoint alone, with no random draws."""
    from dvdx_tpu_torch.pipelines import text2video

    fixture = tree_digest(checkpoint.load_pipeline("zeroscope-tiny", FIXTURE, "cpu"))
    pipe = services._pipeline("zeroscope-tiny-hf", True, "cpu", ckpt="")
    assert tree_digest(pipe) != fixture

    def no_draws(*a, **k):
        raise AssertionError("weights drawn for a checkpoint service")

    monkeypatch.setattr(text2video, "resolve_pipeline", no_draws)
    monkeypatch.setattr(text2video, "build_pipeline", no_draws)
    pipe = services._pipeline("zeroscope-tiny", True, "cpu", ckpt=FIXTURE)
    assert tree_digest(pipe) == fixture
    pipe = services._pipeline("zeroscope-tiny", False, "cpu", ckpt=FIXTURE)
    assert tree_digest(pipe) == fixture
    args = services.parse_args(["miner", "--cpu", "--params-ckpt", FIXTURE])
    assert args.params_ckpt == FIXTURE


def write_fixture(path: str = FIXTURE) -> None:
    """Write the fixture with the JAX package's save_params."""
    jckpt.save_params(_jax_tiny().params, path)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_fixture()
