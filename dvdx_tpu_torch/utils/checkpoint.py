"""Checkpoint load and fetch for pipelines.

Counterpart of ``dvdx_tpu/utils/checkpoint.py``, without JAX or orbax:

* ``load_params`` reads the directory the reference's ``save_params`` writes
  (an orbax ``StandardCheckpointer`` save: ``_METADATA`` with OCDBT on and
  zarr3 off, each array a zarr array under the OCDBT key-value store at
  the path ``'.'.join(tree keys)``) through ``tensorstore``, and loads it
  strictly into a port object through ``utils.bridge``. bfloat16 leaves are
  read by their bytes. Any other layout is refused with a clear error.
* ``fetch_checkpoint`` is the retry-hardened fetch (exponential backoff)
  over a local path, an ``hf://org/name[@revision]`` source or any
  fetcher(src, dst) of one attempt.

Writing checkpoints (``save_params``) is left to the reference.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from .bridge import load_tree, to_tensor


class CheckpointFormatError(ValueError):
    """A checkpoint directory this reader does not take."""


def _array_spec(root: str, keys) -> dict:
    return {"driver": "zarr",
            "kvstore": {"driver": "ocdbt", "base": f"file://{root}/",
                        "path": ".".join(keys) + "/"}}


def read_tree(path: str) -> Dict[str, Any]:
    """An orbax ``save_params`` directory -> nested dict of CPU tensors."""
    root = os.path.abspath(path)
    meta_path = os.path.join(root, "_METADATA")
    if not os.path.exists(meta_path):
        raise CheckpointFormatError(f"{root}: no _METADATA (not an orbax checkpoint)")
    with open(meta_path) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise CheckpointFormatError(
            f"{root}: use_ocdbt={meta.get('use_ocdbt')} use_zarr3={meta.get('use_zarr3')}; "
            "this reader takes OCDBT with zarr v2 (what save_params writes)")
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError("reading an orbax checkpoint needs the tensorstore module, "
                          "which does not import here") from e
    entries = []
    for entry in meta["tree_metadata"].values():
        keys = [k["key"] for k in entry["key_metadata"]]
        kind = entry["value_metadata"].get("value_type", "")
        if kind not in ("jax.Array", "np.ndarray"):
            raise CheckpointFormatError(f"{'/'.join(keys)}: leaf of type {kind!r}")
        entries.append((keys, ts.open(_array_spec(root, keys), open=True, read=True)))
    tree: Dict[str, Any] = {}
    for keys, opening in entries:
        arr = np.asarray(opening.result().read().result())
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = to_tensor(arr)
    return tree


def load_params(path: str, like=None):
    """Read a ``save_params`` directory. With ``like`` (a port pipeline,
    img2vid pipeline, scorer or module), load it into ``like`` strictly, in
    place, and return ``like``; without, return the nested tree."""
    tree = read_tree(path)
    return tree if like is None else load_tree(like, tree)


def load_pipeline(model_name: str, path: str, device="cuda"):
    """A registry name's pipeline skeleton with the checkpoint's weights."""
    from ..models.zoo import get_model_spec
    from ..pipelines.text2video import empty_pipeline

    return load_params(path, like=empty_pipeline(get_model_spec(model_name), device))


def _local_fetcher(src: str, dst: str) -> None:
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(src, dst)


def _hf_snapshot(repo_id: str, revision: Optional[str], dst: str) -> None:
    """One HF-hub snapshot attempt (its own function, so that tests replace
    the network call)."""
    from huggingface_hub import snapshot_download

    snapshot_download(repo_id=repo_id, revision=revision, local_dir=dst,
                      token=os.environ.get("HF_TOKEN") or None)


def hf_fetcher(src: str) -> Callable[[str, str], None]:
    """The fetcher of an ``hf://org/name[@revision]`` source: one attempt;
    ``fetch_checkpoint`` retries."""
    repo_id, _, revision = src[len("hf://"):].partition("@")
    if not repo_id or repo_id.count("/") != 1:
        raise ValueError(f"bad hf source {src!r}; expected hf://org/name[@rev]")

    def fetch(_src: str, dst: str) -> None:
        os.makedirs(dst, exist_ok=True)
        _hf_snapshot(repo_id, revision or None, dst)

    return fetch


def fetch_checkpoint(src: str, dst: str, *, retries: int = 5, backoff_s: float = 1.0,
                     fetcher: Optional[Callable[[str, str], None]] = None) -> str:
    """Fetch ``src`` into ``dst``, retrying every failed attempt after
    backoff_s * 2^attempt seconds. Sources: a local path (copytree),
    ``hf://org/name[@revision]``, or any ``fetcher(src, dst)``."""
    if fetcher is None:
        fetcher = hf_fetcher(src) if src.startswith("hf://") else _local_fetcher
    last_err: Optional[Exception] = None
    for attempt in range(retries):
        try:
            fetcher(src, dst)
            return dst
        except Exception as e:  # noqa: BLE001 - every failure is retried
            last_err = e
            if attempt < retries - 1:
                time.sleep(backoff_s * (2 ** attempt))
    raise RuntimeError(f"checkpoint fetch failed after {retries} attempts: {last_err}")
