"""``DVDX_PARAM_CACHE``: ``build_pipeline``'s flat-npz weight cache against a
fresh draw and against the JAX package's reader, bit for bit (tolerance 0).

* a miss draws and writes ``<dir>/<model>-s<seed>-<dtype>-<tag>.npz``; a hit
  loads it with no draw and is bit-equal to a fresh draw, for
  zeroscope-tiny, zeroscope-tiny-hf, dit-tiny and a bf16 zeroscope-tiny;
* the JAX package's ``_load_flat_npz`` reads the port's file as the JAX
  ``build_pipeline``'s params, leaf for leaf;
* another tag (another ``utils/init.py`` or spec) misses; a corrupt file,
  or one whose tree does not match the modules, is drawn again and
  rewritten; a fault of the copy to the device raises; without the
  variable nothing is written.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
from jax.tree_util import tree_flatten_with_path

from dvdx_tpu.pipelines.text2video import _load_flat_npz
from dvdx_tpu.pipelines.text2video import build_pipeline as jbuild
from dvdx_tpu_torch.models.zoo import get_model_spec
from dvdx_tpu_torch.pipelines import text2video
from dvdx_tpu_torch.utils.init import tree_digest
from tests.test_torch_init import _bf16_spec, _bits

CASES = ["zeroscope-tiny", "zeroscope-tiny-hf", "dit-tiny", "zeroscope-tiny:bf16"]


def _spec(case):
    name, _, dtype = case.partition(":")
    return _bf16_spec(name) if dtype else get_model_spec(name)


@pytest.fixture
def draws(monkeypatch):
    """Count the ``fast_init`` calls of ``build_pipeline`` (three per draw)."""
    calls = []
    real = text2video.fast_init

    def counted(*a, **kw):
        calls.append(a[1])
        return real(*a, **kw)

    monkeypatch.setattr(text2video, "fast_init", counted)
    return calls


def _leaves(tree) -> dict:
    return {tuple(k.key for k in path): np.asarray(v)
            for path, v in tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("case", CASES)
def test_hit_equals_a_fresh_draw_and_the_jax_params(case, tmp_path, monkeypatch, draws):
    spec = _spec(case)
    monkeypatch.delenv("DVDX_PARAM_CACHE", raising=False)
    fresh = tree_digest(text2video.build_pipeline(spec, seed=2, device="cpu"))
    assert text2video.param_cache_path(spec, 2) is None
    monkeypatch.setenv("DVDX_PARAM_CACHE", str(tmp_path))
    path = text2video.param_cache_path(spec, 2)
    dtype = "bfloat16" if case.endswith(":bf16") else "float32"
    assert os.path.basename(path) == (f"{spec.name}-s2-{dtype}-"
                                      f"{text2video.init_scheme_tag(spec)}.npz")
    del draws[:]
    miss = text2video.build_pipeline(spec, seed=2, device="cpu")
    assert draws == [2, 3, 4] and os.path.exists(path)
    hit = text2video.build_pipeline(spec, seed=2, device="cpu")
    assert draws == [2, 3, 4]  # the hit drew nothing
    assert tree_digest(hit) == tree_digest(miss) == fresh
    # the JAX package reads the port's file as its own build_pipeline's tree
    want = _leaves(jbuild(spec.name, seed=2, params_dtype=getattr(jnp, dtype)).params)
    got = _leaves(_load_flat_npz(path))
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].shape == value.shape and got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(_bits(got[key]), _bits(value), err_msg=str(key))


def test_another_tag_misses(tmp_path, monkeypatch, draws):
    monkeypatch.setenv("DVDX_PARAM_CACHE", str(tmp_path))
    spec = get_model_spec("zeroscope-tiny")
    first = tree_digest(text2video.build_pipeline(spec, device="cpu"))
    monkeypatch.setattr(text2video, "init_scheme_tag", lambda spec: "another-rule")
    del draws[:]
    again = tree_digest(text2video.build_pipeline(spec, device="cpu"))
    assert draws == [0, 1, 2] and again == first
    names = sorted(os.listdir(tmp_path))
    assert len(names) == 2 and any(n.endswith("-another-rule.npz") for n in names)


@pytest.mark.parametrize("damage", [b"", b"not an npz", None])
def test_a_corrupt_file_is_drawn_again(tmp_path, monkeypatch, draws, capsys, damage):
    """An empty file, garbage, or a file cut short is drawn again, and the
    file is rewritten so the next start hits."""
    monkeypatch.setenv("DVDX_PARAM_CACHE", str(tmp_path))
    spec = get_model_spec("zeroscope-tiny-hf")
    want = tree_digest(text2video.build_pipeline(spec, device="cpu"))
    path = text2video.param_cache_path(spec, 0)
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:len(raw) // 2] if damage is None else damage)
    del draws[:]
    capsys.readouterr()
    assert tree_digest(text2video.build_pipeline(spec, device="cpu")) == want
    assert draws == [0, 1, 2]
    assert "drawing the weights again" in capsys.readouterr().err
    assert tree_digest(text2video.build_pipeline(spec, device="cpu")) == want
    assert draws == [0, 1, 2]
    assert [n for n in os.listdir(tmp_path) if n.endswith(".tmp.npz")] == []


def _rewrite(path, edit):
    """The npz at ``path`` with its entries passed through ``edit``."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    with open(path, "wb") as f:
        np.savez(f, **edit(flat))


def _drop_a_leaf(flat):
    return dict(sorted(flat.items())[1:])


def _reshape_a_leaf(flat):
    for key in sorted(flat):
        name, dtype, shape = key.rsplit("|", 2)
        dims = shape.split(",")
        if len(set(dims)) > 1:
            flat[f"{name}|{dtype}|{','.join(dims[::-1])}"] = flat.pop(key)
            return flat


@pytest.mark.parametrize("edit", [_drop_a_leaf, _reshape_a_leaf])
def test_a_file_that_does_not_match_is_drawn_again(tmp_path, monkeypatch, draws, capsys, edit):
    """A file that reads but whose tree does not match the modules (a leaf
    missing, a leaf of another shape) is drawn again, with a note on
    stderr, and rewritten."""
    monkeypatch.setenv("DVDX_PARAM_CACHE", str(tmp_path))
    spec = get_model_spec("zeroscope-tiny-hf")
    want = tree_digest(text2video.build_pipeline(spec, device="cpu"))
    path = text2video.param_cache_path(spec, 0)
    _rewrite(path, edit)
    del draws[:]
    capsys.readouterr()
    assert tree_digest(text2video.build_pipeline(spec, device="cpu")) == want
    assert draws == [0, 1, 2]
    assert "drawing the weights again" in capsys.readouterr().err
    assert tree_digest(text2video.build_pipeline(spec, device="cpu")) == want
    assert draws == [0, 1, 2]


def test_a_fault_of_the_copy_raises(tmp_path, monkeypatch, draws):
    """A fault while the file's values reach the device (out of memory, a
    device error) is not taken for a bad file: it raises, and nothing is
    drawn in its place."""
    monkeypatch.setenv("DVDX_PARAM_CACHE", str(tmp_path))
    spec = get_model_spec("zeroscope-tiny")
    text2video.build_pipeline(spec, device="cpu")

    def fault(obj, tree):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(text2video, "load_tree", fault)
    del draws[:]
    with pytest.raises(RuntimeError, match="out of memory"):
        text2video.build_pipeline(spec, device="cpu")
    assert draws == []
