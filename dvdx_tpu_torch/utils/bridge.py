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
* a norm's ``scale`` (LayerNorm, GroupNorm, T5's RMSNorm) becomes
  ``weight``, an embedding's ``embedding``
  becomes ``weight``; ``bias`` and bare parameters keep their names.

One table (``_LAYOUTS``) holds both directions. ``flax_leaves`` runs it
backwards: every parameter of a port object with its path in the
reference's tree, its flax shape and layout, in ``jax.tree.flatten`` order,
which ``utils/init.fast_init`` and ``utils/testing.perturb_zero_params``
draw over.

The load is strict: every parameter of the module is set exactly once, with
its shape checked. Leaves are numpy arrays as ``jax.tree.map(np.asarray,
params)`` gives them, or torch tensors; bfloat16 numpy leaves are read by
their bytes, so ``ml_dtypes`` is never needed. ``load_flat_npz`` reads the
reference's flat-npz parameter cache (``dvdx_tpu/pipelines/text2video.py``
``_save_flat_npz``) the same way, ``save_flat_npz`` writes it from a port
object, and ``load_lpips_params`` reads the JAX package's flat LPIPS(alex)
parameter dict.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.layers import GroupNorm
from ..models.t5 import RMSNorm


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


def _temporal(conv: nn.Conv2d) -> bool:
    """The (3, 1, 1) temporal conv runs as a (3, 1) conv over (B, F, H*W, C);
    every other conv of the port is square."""
    return tuple(conv.kernel_size) == (3, 1)


def _conv_to_torch(conv: nn.Conv2d, v):
    if v.dim() == 5:  # (3, 1, 1, I, O) temporal conv
        v = v[:, :, 0]
    return v.permute(3, 2, 0, 1)


def _conv_to_flax(conv: nn.Conv2d, w):
    v = w.permute(2, 3, 1, 0)
    return v[:, :, None] if _temporal(conv) else v


def _conv_flax_shape(conv: nn.Conv2d, shape):
    o, i, h, w = shape
    return (h, w, 1, i, o) if _temporal(conv) else (h, w, i, o)


# The one layout table, both directions: a torch ``weight`` of an owner of
# this type is the flax leaf of this name; (to torch, to flax, flax shape).
# Every other parameter (``bias``, bare parameters) keeps its name and layout.
_LAYOUTS = (
    (nn.Linear, "kernel", lambda m, v: v.t(), lambda m, w: w.t(),
     lambda m, s: (s[1], s[0])),
    (nn.Conv2d, "kernel", _conv_to_torch, _conv_to_flax, _conv_flax_shape),
    (nn.Embedding, "embedding", None, None, None),
    ((nn.LayerNorm, GroupNorm, RMSNorm), "scale", None, None, None),
)


def _layout(owner: nn.Module, name: str):
    """(flax leaf name, to torch, to flax, flax shape) of ``owner.name``."""
    if name == "weight":
        for types, leaf, to_torch, to_flax, shape in _LAYOUTS:
            if isinstance(owner, types):
                return leaf, to_torch, to_flax, shape
        raise TypeError(f"no flax layout for the weight of {type(owner).__name__}")
    return name, None, None, None


def _target(module: nn.Module, path: Tuple[str, ...], value: torch.Tensor):
    """(parameter name in the module, value in the port's layout)."""
    *mod_path, leaf = path
    try:
        owner = module.get_submodule(".".join(mod_path))
    except AttributeError as e:
        raise KeyError(f"{'/'.join(path)}: no such module in the port ({e})") from None
    name = {"kernel": "weight", "scale": "weight", "embedding": "weight"}.get(leaf, leaf)
    flax_leaf, to_torch, _, _ = _layout(owner, name)
    if flax_leaf != leaf:
        raise TypeError(f"{'/'.join(path)}: no {leaf!r} layout for {type(owner).__name__}")
    return ".".join(mod_path + [name]), value if to_torch is None else to_torch(owner, value)


@dataclasses.dataclass(frozen=True)
class FlaxLeaf:
    """One parameter of the port seen as the reference's flax leaf: its path
    in the reference's tree (``('unet', 'params', 'conv_in', 'kernel')``),
    the parameter, and its owner module."""

    path: Tuple[str, ...]
    param: nn.Parameter
    owner: Optional[nn.Module]
    torch_name: str

    @property
    def key(self) -> str:
        """The path as ``utils/init`` keys its draws: ``'/'.join`` of the path
        inside one flax tree (from its ``params`` level on)."""
        inner = self.path[self.path.index("params"):] if "params" in self.path else self.path
        return "/".join(inner)

    def _layout(self):
        if self.owner is None:
            return self.path[-1], None, None, None
        return _layout(self.owner, self.torch_name.rsplit(".", 1)[-1])

    @property
    def shape(self) -> Tuple[int, ...]:
        """The leaf's shape in the flax layout."""
        shape = self._layout()[3]
        torch_shape = tuple(self.param.shape)
        return torch_shape if shape is None else tuple(shape(self.owner, torch_shape))

    def to_torch(self, value: torch.Tensor) -> torch.Tensor:
        """A flax-layout value -> this parameter's layout (a view where it can)."""
        fn = self._layout()[1]
        return value if fn is None else fn(self.owner, value)

    def to_flax(self, value: torch.Tensor) -> torch.Tensor:
        """A value in this parameter's layout -> the flax layout (a view)."""
        fn = self._layout()[2]
        return value if fn is None else fn(self.owner, value)


def flax_trees(obj) -> Dict[str, Any]:
    """The reference's top-level tree of a port object: a name per module
    (``Pipeline.flax_trees()``: 'unet', 'text', 'vae_dec'; an img2vid
    pipeline adds 'vae_enc'; the CLIP scorer 'vision', 'text' and the bare
    'text_proj'), or ``{'': module}`` for a module that is one flax tree."""
    trees = getattr(obj, "flax_trees", None)
    return trees() if trees is not None else {"": obj}


def flax_leaves(obj) -> list:
    """Every parameter of ``obj`` as a ``FlaxLeaf``, in ``jax.tree.flatten``
    order of the reference's tree (dict keys sorted at every level)."""
    out = []
    for top, sub in flax_trees(obj).items():
        head = (top,) if top else ()
        if isinstance(sub, nn.Parameter):
            out.append(FlaxLeaf(head, sub, None, top))
            continue
        for mod_name, owner in sub.named_modules():
            mod_path = tuple(mod_name.split(".")) if mod_name else ()
            for name, param in owner.named_parameters(recurse=False):
                leaf = _layout(owner, name)[0]
                out.append(FlaxLeaf(head + ("params",) + mod_path + (leaf,), param, owner,
                                    ".".join(mod_path + (name,))))
    return sorted(out, key=lambda leaf: leaf.path)


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
            raw = z[key]  # a fresh, writable array: the tensor takes it as it is
            if dtype_name == "bfloat16":
                leaf = torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
            else:
                leaf = torch.from_numpy(raw.view(np.dtype(dtype_name)))
            flat[name] = leaf.reshape(shape)
    return unflatten(flat)


def save_flat_npz(path: str, obj) -> None:
    """Every parameter of ``obj`` (a pipeline, or one module) in the
    reference's flat-npz layout, which ``load_flat_npz`` and the reference's
    ``_load_flat_npz`` read: one entry per flax leaf, keyed
    ``'/'.join(path)|dtype|shape`` over its raw bytes in the flax layout.
    Written to a unique temporary file in the same directory and renamed into
    place, so processes that write the same path at once never leave a mixed
    file."""
    import os
    import tempfile

    flat = {}
    for leaf in flax_leaves(obj):
        value = leaf.to_flax(leaf.param.detach()).contiguous().cpu()
        name = str(value.dtype).replace("torch.", "")
        if value.dtype == torch.bfloat16:
            value = value.view(torch.int16)
        key = f"{'/'.join(leaf.path)}|{name}|{','.join(map(str, value.shape))}"
        flat[key] = value.numpy().reshape(-1).view(np.uint8)
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_pipeline_params(pipe, tree: Dict[str, Any]):
    """The reference's ``Pipeline.params`` ({'unet', 'text', 'vae_dec'}) into
    a port ``Pipeline``'s three modules. 'unet' is the family's denoiser
    tree: the UNet3D's, or the VideoDiT's (``block{i}/{adaln_zero, to_q,
    to_k, to_v, to_out, fc1, fc2}``, ``patch_embed``, ``text_proj``,
    ``time_embedding``, ``final_ln``, ``proj_out_zero``)."""
    return load_tree(pipe, {name: tree[name] for name in pipe.flax_trees()})


def load_tree(obj, tree: Dict[str, Any]):
    """The reference's whole tree of ``obj`` (a pipeline's {'unet', 'text',
    'vae_dec'}, an img2vid pipeline's with 'vae_enc', the scorer's, or one
    module's {'params': ...}) into ``obj`` strictly, in place: every
    top-level name must be one of ``flax_trees(obj)`` and every one given."""
    trees = flax_trees(obj)
    if set(trees) == {""}:
        return load_jax_params(obj, tree)
    if set(tree) != set(trees):
        raise KeyError(f"tree names {sorted(tree)}, the port's {sorted(trees)}")
    with torch.no_grad():
        for name, sub in trees.items():
            if isinstance(sub, nn.Parameter):
                value = to_tensor(tree[name])
                if tuple(value.shape) != tuple(sub.shape):
                    raise ValueError(f"{name}: shape {tuple(value.shape)} from the tree, "
                                     f"{tuple(sub.shape)} in the port")
                sub.copy_(value.to(sub.dtype))
            else:
                load_jax_params(sub, tree[name])
    return obj


def load_lpips_params(module, params: Dict[str, Any]):
    """The JAX package's ``LPIPS.params`` ({'convK/kernel', 'convK/bias',
    'linK', 'shift', 'scale'}, numpy or JAX arrays as numpy) into a port
    ``scoring.lpips.LPIPS`` (whose ``shift`` / ``scale`` are ``in_shift`` /
    ``in_scale``), strictly."""
    renamed = {{"shift": "in_shift", "scale": "in_scale"}.get(k, k): np.asarray(v)
               for k, v in params.items()}
    return load_jax_params(module, unflatten(renamed))
