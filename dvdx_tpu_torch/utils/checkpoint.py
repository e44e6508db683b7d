"""Checkpoint save, load and fetch for pipelines.

Counterpart of ``dvdx_tpu/utils/checkpoint.py``, without JAX or orbax:

* ``load_params`` reads the directory the reference's ``save_params`` writes
  (an orbax ``StandardCheckpointer`` save: ``_METADATA`` with OCDBT on and
  zarr3 off, each array a zarr array under the OCDBT key-value store at
  the path ``'.'.join(tree keys)``) through ``tensorstore``, and loads it
  strictly into a port object through ``utils.bridge``. bfloat16 leaves are
  read by their bytes. Any other layout is refused with a clear error.
* ``save_params`` writes that layout from a port object through
  ``tensorstore``: every flax leaf (``utils.bridge.flax_leaves``) as a zarr
  v2 array (one zstd chunk) under the OCDBT store, bfloat16 by its bytes,
  ``_METADATA``, ``_CHECKPOINT_METADATA`` and the ``_sharding`` file the
  reference's ``load_params`` needs when its target carries no sharding
  (each leaf on JAX's first CPU device, as a CPU host's orbax save names
  it). ``load_params`` here and the reference's both read it back.
* ``fetch_checkpoint`` is the retry-hardened fetch (exponential backoff)
  over a local path, an ``hf://org/name[@revision]`` source or any
  fetcher(src, dst) of one attempt.

Both directions need ``tensorstore``; where it does not import they raise
``ImportError`` naming it.
"""

from __future__ import annotations

import base64
import json
import os
import shutil
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .bridge import flax_leaves, load_tree, to_tensor

# the OCDBT store's settings and the chunk compressor of an orbax save
OCDBT_CONFIG = {"compression": {"id": "zstd"}, "max_decoded_node_bytes": 100000000,
                "max_inline_value_bytes": 1024, "version_tree_arity_log2": 4}
ZARR_COMPRESSOR = {"id": "zstd", "level": 1}
HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
# where the reference's load_params places a leaf when its target has no
# sharding: JAX's first CPU device, which every JAX host has
SHARDING = json.dumps({"sharding_type": "SingleDeviceSharding", "device_str": "TFRT_CPU_0"})


class CheckpointFormatError(ValueError):
    """A checkpoint directory this reader does not take."""


def _array_spec(root: str, keys) -> dict:
    return {"driver": "zarr",
            "kvstore": {"driver": "ocdbt", "base": f"file://{root}/",
                        "path": ".".join(keys) + "/"}}


def _tensorstore(what: str):
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(f"{what} an orbax checkpoint needs the tensorstore module, "
                          "which does not import here") from e
    return ts


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
    ts = _tensorstore("reading")
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


def save_params(obj, path: str) -> None:
    """Write every parameter of ``obj`` (a pipeline, img2vid pipeline,
    scorer or module) as the reference's ``save_params`` writes its tree:
    the directory is replaced, leaves are in the flax layout under their
    reference paths."""
    ts = _tensorstore("writing")
    root = os.path.abspath(path)
    if os.path.exists(root):
        shutil.rmtree(root)
    os.makedirs(root)
    context = ts.Context()
    tree, sharding, writes = {}, {}, []
    for leaf in flax_leaves(obj):
        value = leaf.to_flax(leaf.param.detach()).contiguous().cpu()
        if value.dtype == torch.bfloat16:
            arr, dtype = value.view(torch.int16).numpy().view(ts.bfloat16.numpy_dtype), "bfloat16"
        else:
            arr = value.numpy()
            dtype = arr.dtype.str
        spec = _array_spec(root, leaf.path)
        spec["kvstore"]["config"] = OCDBT_CONFIG
        spec["metadata"] = {"shape": list(arr.shape), "chunks": list(arr.shape), "dtype": dtype,
                            "compressor": ZARR_COMPRESSOR, "fill_value": None, "order": "C",
                            "filters": None, "dimension_separator": "."}
        store = ts.open(spec, create=True, context=context).result()
        writes.append(store.write(arr))
        tree[str(leaf.path)] = {
            "key_metadata": [{"key": k, "key_type": 2} for k in leaf.path],
            "value_metadata": {"value_type": "jax.Array", "skip_deserialize": False,
                               "write_shape": list(arr.shape)}}
        name = base64.urlsafe_b64encode(".".join(leaf.path).encode()).decode()
        sharding[name] = SHARDING
    for write in writes:
        write.result()
    now = time.time_ns()
    for name, content in (
            ("_METADATA", {"tree_metadata": tree, "use_ocdbt": True, "use_zarr3": False,
                           "store_array_data_equal_to_fill_value": True,
                           "custom_metadata": None}),
            ("_sharding", sharding),
            ("_CHECKPOINT_METADATA", {"item_handlers": HANDLER, "metrics": {},
                                      "performance_metrics": {}, "init_timestamp_nsecs": now,
                                      "commit_timestamp_nsecs": now, "custom_metadata": {}})):
        with open(os.path.join(root, name), "w") as f:
            json.dump(content, f)


def save_pipeline(pipe, path: str) -> None:
    """The reference's ``save_pipeline``: a pipeline's weights as
    ``save_params`` writes them."""
    save_params(pipe, path)


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
