"""Weight bridge: the reference's flax parameter tree -> the port's modules.

The port's modules carry the reference's module names, so a flax leaf
``a/b/c/kernel`` lands on ``module.get_submodule("a.b.c")`` (the UNet3D of
both temporal styles, the rotary mixers' ``norm`` / ``to_q`` / ``to_k`` /
``to_v`` / ``to_out_zero`` included, the video DiT, the text encoder, the
VAE decoder and encoder, and the CLIP scorer's vision tower, text tower and
``text_proj``):

* a dense ``kernel`` (in, out) becomes ``nn.Linear.weight`` (out, in);
* a conv ``kernel`` in HWIO becomes OIHW; the (3, 1, 1, I, O) temporal conv
  kernel becomes (O, I, 3, 1) (the port runs it as a (3, 1) conv over
  (B, F, H*W, C));
* a norm's ``scale`` becomes ``weight``, an embedding's ``embedding``
  becomes ``weight``; ``bias`` and bare parameters keep their names.

The load is strict: every parameter of the module is set exactly once, with
its shape checked. Leaves are numpy arrays as ``jax.tree.map(np.asarray,
params)`` gives them, or torch tensors; bfloat16 numpy leaves are read by
their bytes, so ``ml_dtypes`` is never needed. ``load_flat_npz`` reads the
reference's flat-npz parameter cache (``dvdx_tpu/pipelines/text2video.py``
``_save_flat_npz``) the same way, and ``load_lpips_params`` the JAX
package's flat LPIPS(alex) parameter dict.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn


def to_tensor(leaf: Any) -> torch.Tensor:
    """numpy (bfloat16 included) or torch leaf -> torch tensor (a CPU copy
    for numpy leaves)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.view(np.int16)).view(torch.bfloat16)
    return torch.tensor(arr)


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator:
    """(module path, leaf) pairs; a flax ``params`` collection level, at the
    top or inside a subtree, adds nothing to the path."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix if key == "params" else prefix + (key,))
        else:
            yield prefix + (key,), value


def _target(module: nn.Module, path: Tuple[str, ...], value: torch.Tensor):
    """(parameter name in the module, value in the port's layout)."""
    *mod_path, leaf = path
    owner = module.get_submodule(".".join(mod_path))
    name = ".".join(mod_path + [{"kernel": "weight", "scale": "weight",
                                 "embedding": "weight"}.get(leaf, leaf)])
    if leaf == "kernel":
        if isinstance(owner, nn.Linear):
            value = value.t()
        elif isinstance(owner, nn.Conv2d):
            if value.dim() == 5:  # (3, 1, 1, I, O) temporal conv
                value = value[:, :, 0]
            value = value.permute(3, 2, 0, 1)
        else:
            raise TypeError(f"{'/'.join(path)}: no kernel layout for {type(owner).__name__}")
    return name, value


def load_jax_params(module: nn.Module, tree: Dict[str, Any]) -> nn.Module:
    """Copy a flax parameter tree ({'params': {...}} or its inside) into
    ``module`` in place, keeping each parameter's dtype and device. A tree
    of several flax trees (the scorer's {'vision': {'params': ...}, 'text':
    {'params': ...}, 'text_proj': array}) maps onto the module's children
    of those names and its own bare parameters."""
    params = dict(module.named_parameters())
    seen = set()
    with torch.no_grad():
        for path, leaf in _leaves(tree):
            name, value = _target(module, path, to_tensor(leaf))
            if name not in params:
                raise KeyError(f"{'/'.join(path)}: no parameter {name!r} in the port")
            if name in seen:
                raise KeyError(f"{name!r} set twice")
            param = params[name]
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{name}: shape {tuple(value.shape)} from the tree, "
                                 f"{tuple(param.shape)} in the port")
            param.copy_(value.to(param.dtype))
            seen.add(name)
    missing = sorted(set(params) - seen)
    if missing:
        raise KeyError(f"parameters not in the tree: {missing[:8]} ({len(missing)})")
    return module


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{'a/b/c': leaf} -> {'a': {'b': {'c': leaf}}}."""
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def load_flat_npz(path: str) -> Dict[str, Any]:
    """The reference's flat-npz cache -> nested dict of CPU tensors. Keys are
    ``name/path|dtype|shape`` over the leaf's raw bytes."""
    flat: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            name, dtype_name, shape_s = key.rsplit("|", 2)
            shape = tuple(int(x) for x in shape_s.split(",") if x)
            raw = z[key]
            if dtype_name == "bfloat16":
                leaf = torch.from_numpy(raw.view(np.int16).copy()).view(torch.bfloat16)
            else:
                leaf = torch.from_numpy(raw.view(np.dtype(dtype_name)).copy())
            flat[name] = leaf.reshape(shape)
    return unflatten(flat)


def load_pipeline_params(pipe, tree: Dict[str, Any]):
    """The reference's ``Pipeline.params`` ({'unet', 'text', 'vae_dec'}) into
    a port ``Pipeline``'s three modules. 'unet' is the family's denoiser
    tree: the UNet3D's, or the VideoDiT's (``block{i}/{adaln_zero, to_q,
    to_k, to_v, to_out, fc1, fc2}``, ``patch_embed``, ``text_proj``,
    ``time_embedding``, ``final_ln``, ``proj_out_zero``)."""
    load_jax_params(pipe.unet, tree["unet"])
    load_jax_params(pipe.text_encoder, tree["text"])
    load_jax_params(pipe.vae_decoder, tree["vae_dec"])
    return pipe


def load_lpips_params(module, params: Dict[str, Any]):
    """The JAX package's ``LPIPS.params`` ({'convK/kernel', 'convK/bias',
    'linK', 'shift', 'scale'}, numpy or JAX arrays as numpy) into a port
    ``scoring.lpips.LPIPS`` (whose ``shift`` / ``scale`` are ``in_shift`` /
    ``in_scale``), strictly."""
    renamed = {{"shift": "in_shift", "scale": "in_scale"}.get(k, k): np.asarray(v)
               for k, v in params.items()}
    return load_jax_params(module, unflatten(renamed))
