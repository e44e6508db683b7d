"""Parameter sharding over the mesh's ``model`` axis: the FSDP / ZeRO-3
counterpart of ``dvdx_tpu/parallel/sharding.py``.

Placement (``_leaf_spec``, the JAX package's rule): a leaf of at least 2^14
elements is split along its largest divisible axis, trailing axes first;
smaller leaves, and every leaf at model size 1, are replicated.
``sharded_size_per_device`` counts the bytes one device holds under that
rule, as the JAX function does for the same tree (the port's leaves are the
JAX tree's leaves, transposed where ``utils.bridge`` transposes them, which
changes no divisibility and so no byte count).

Execution is forward hooks on the model-axis subgroup, as torch's FSDP
does it: ``shard_module`` keeps only this rank's shard of every large leaf
of a module tree, the shards of each unit (every direct child of the tree's
root, and the root for its own leaves) packed into one flat buffer per
dtype; a pre-forward hook all-gathers a unit's buffer just before the unit
runs and rebuilds its leaves whole, and a forward hook frees them after.
The gathered tensors are the whole leaves, bit for bit, so a sharded run
computes what the unsharded one does. At model size 1 the hooks still run (a
one-rank all-gather), so a one-rank NCCL group takes the same path as a
larger one.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

MIN_SHARD_ELEMS = 2 ** 14


def _shard_axis(shape: Sequence[int], model_size: int,
                min_shard_elems: int = MIN_SHARD_ELEMS) -> Optional[int]:
    """The axis a leaf splits along over ``model_size`` ranks (trailing
    first, the first that divides), or None to replicate."""
    if int(np.prod(shape)) < min_shard_elems:
        return None
    for ax in reversed(range(len(shape))):
        if shape[ax] % model_size == 0 and shape[ax] >= model_size:
            return ax
    return None


def _leaf_spec(shape: Sequence[int], model_size: int,
               min_shard_elems: int = MIN_SHARD_ELEMS) -> tuple:
    """The JAX PartitionSpec of one leaf as a tuple: "model" at the split
    axis, None elsewhere; () when replicated."""
    if model_size <= 1:
        return ()
    ax = _shard_axis(shape, model_size, min_shard_elems)
    if ax is None:
        return ()
    spec = [None] * len(shape)
    spec[ax] = "model"
    return tuple(spec)


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def sharded_size_per_device(params: Any, mesh, shard: bool = True) -> int:
    """Parameter bytes resident on one device: a module, a dict of modules,
    or a tree of tensors / arrays."""
    model_size = mesh.shape["model"] if shard else 1
    total = 0
    for leaf in _leaves(params):
        n = int(np.prod(leaf.shape)) * (leaf.element_size() if isinstance(leaf, torch.Tensor)
                                        else leaf.dtype.itemsize)
        total += n // model_size if any(_leaf_spec(leaf.shape, model_size)) else n
    return total


class _Leaf:
    """One sharded parameter: its split axis, memory format, its shard's
    shape (split axis first) and its place in its unit's flat buffer."""

    def __init__(self, param: nn.Parameter, axis: int, size: int):
        self.param, self.axis = param, axis
        self.channels_last = (param.dim() == 4 and not param.is_contiguous()
                              and param.is_contiguous(memory_format=torch.channels_last))
        moved = param.shape[axis:axis + 1] + param.shape[:axis] + param.shape[axis + 1:]
        self.shard_shape = (moved[0] // size,) + tuple(moved[1:])
        self.numel = int(np.prod(self.shard_shape))
        self.offset = 0


class _Unit:
    """The leaves of one dtype of one unit, their shards packed into one flat
    buffer: one all-gather brings the whole unit."""

    def __init__(self, leaves: List[_Leaf], size: int, pos: int):
        self.leaves = leaves
        with torch.no_grad():
            self.flat = torch.cat([
                leaf.param.detach().movedim(leaf.axis, 0).chunk(size, dim=0)[pos].reshape(-1)
                for leaf in leaves])
        offset = 0
        for leaf in leaves:
            leaf.offset, offset = offset, offset + leaf.numel

    def shard(self, leaf: _Leaf) -> torch.Tensor:
        return self.flat[leaf.offset:leaf.offset + leaf.numel].view(leaf.shard_shape)


class ShardedModule:
    """The hooks and shards of one module tree; ``remove`` restores the
    whole parameters and takes the hooks off."""

    def __init__(self, root: nn.Module, mesh, min_shard_elems: int = MIN_SHARD_ELEMS):
        self.root, self.mesh = root, mesh
        self.group = mesh.group(("model",))
        self.size = mesh.shape["model"]
        self._hooks = []
        self._units: Dict[nn.Module, List[_Unit]] = {}
        self.gathers = 0  # unit all-gathers since sharding (a plain count)
        units = [(root, list(root.parameters(recurse=False)))]
        for child in _forward_children(root):
            units.append((child, list(child.parameters())))
        for unit, params in units:
            by_dtype: Dict[torch.dtype, List[_Leaf]] = {}
            for p in params:
                ax = _shard_axis(p.shape, self.size, min_shard_elems)
                if ax is not None:
                    by_dtype.setdefault(p.dtype, []).append(_Leaf(p, ax, self.size))
            if not by_dtype:
                continue
            self._units[unit] = [_Unit(leaves, self.size, mesh.coords["model"])
                                 for leaves in by_dtype.values()]
            for u in self._units[unit]:  # the unit's whole leaves are freed before the next
                for leaf in u.leaves:
                    _set(leaf.param, u.shard(leaf))
            self._hooks.append(unit.register_forward_pre_hook(self._pre))
            self._hooks.append(unit.register_forward_hook(self._post))
        root._dvdx_sharded = True

    def _gather(self, u: _Unit, own: bool = False) -> None:
        """All-gather the unit's flat shards, then each leaf whole, in its
        own layout and memory format: a view into the gathered buffer where
        the layout allows (freed with the unit's post-hook), or with
        ``own`` a storage of its own (the gathered buffer is then freed)."""
        parts = [torch.empty_like(u.flat) for _ in range(self.size)]
        dist.all_gather(parts, u.flat, group=self.group)
        for leaf in u.leaves:
            segs = [p[leaf.offset:leaf.offset + leaf.numel].view(leaf.shard_shape)
                    for p in parts]
            full = (segs[0] if self.size == 1 else torch.cat(segs, dim=0)).movedim(0, leaf.axis)
            fmt = torch.channels_last if leaf.channels_last else torch.contiguous_format
            _set(leaf.param, full.clone(memory_format=fmt) if own
                 else full.contiguous(memory_format=fmt))

    def _pre(self, module, _args):
        self.gathers += 1
        with torch.inference_mode(False), torch.no_grad():
            for u in self._units[module]:
                self._gather(u)

    def _post(self, module, _args, _out):
        for u in self._units[module]:
            for leaf in u.leaves:
                _set(leaf.param, u.shard(leaf))

    def remove(self) -> None:
        """Whole parameters back in place (one more all-gather each unit),
        hooks off."""
        for h in self._hooks:
            h.remove()
        with torch.inference_mode(False), torch.no_grad():
            for flat_units in self._units.values():
                for u in flat_units:
                    self._gather(u, own=True)
        self._hooks, self._units = [], {}
        self.root._dvdx_sharded = False


def _forward_children(root: nn.Module):
    """The units of a tree: its direct children, through containers that
    have no forward of their own (ModuleList / ModuleDict)."""
    for child in root.children():
        if isinstance(child, (nn.ModuleList, nn.ModuleDict)):
            yield from _forward_children(child)
        else:
            yield child


def _set(param: nn.Parameter, value: torch.Tensor) -> None:
    param.data = value


def shard_module(module: nn.Module, mesh) -> Optional[ShardedModule]:
    """Shard ``module``'s large leaves over ``mesh``'s model axis in place;
    None when the mesh has no process group (nothing to gather over)."""
    if mesh.group(("model",)) is None:
        return None
    if getattr(module, "_dvdx_sharded", False):
        raise RuntimeError("shard_module: the module is sharded already (close the "
                           "runner or engine that sharded it first)")
    return ShardedModule(module, mesh)


def shard_pipeline(pipe, mesh) -> List[ShardedModule]:
    """``shard_module`` on the pipeline's denoiser, text encoder and VAE
    decoder (the reference's FSDP wraps all three)."""
    out = []
    for m in (pipe.unet, pipe.text_encoder, pipe.vae_decoder):
        handle = shard_module(m, mesh)
        if handle is not None:
            out.append(handle)
    return out
