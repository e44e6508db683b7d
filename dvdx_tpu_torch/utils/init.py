"""Host-side (numpy) parameter initialisation, bit-equal to the reference's.

Counterpart of ``dvdx_tpu/utils/init.py``. Every leaf is a pure function of
(seed, the leaf's path in the reference's flax tree), so a registry name and
a seed give every host of either package the same weights, bit for bit
(the Proof-of-Inference determinism chain's weight step). Rules, by path,
in this order:

* any path component containing ``_zero``, or a leaf named ``bias`` -> zeros
* a leaf named ``scale`` (Layer / GroupNorm)                        -> ones
* a leaf name containing ``embedding``, or ``cls_token``            -> N(0, 0.02)
* any other leaf                                                    -> lecun normal,
  N(0, 1/fan_in) with fan_in = prod(flax shape[:-1])

The draws are numpy ``SFC64`` keyed by the first 8 bytes (big-endian) of
sha256(f"{seed}:{path}"), where the path starts at the ``params``
collection (``params/conv_in/kernel``): float32 ``standard_normal`` in the
flax shape, C order, times float32(scale). Each leaf is then cast once to
``dtype`` (round to nearest even, as ``ml_dtypes`` casts) and moved into
the port's layout through ``utils.bridge.flax_leaves``.
"""

from __future__ import annotations

import collections
import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from .bridge import flax_leaves

# numpy's Generator fill releases the GIL, so the draws run on threads (the
# JAX package uses 4; the count changes no bit)
DRAW_WORKERS = min(8, os.cpu_count() or 4)

# tree_digest of (registry name, seed, perturbation seed): the reference's
# build_pipeline(name, seed) with perturb_zero_params(seed=...), computed
# with the JAX package leaf by leaf (tests/test_torch_init.py recomputes it)
REFERENCE_DIGESTS = {
    ("zeroscope-v2-576w", 0, 99):
        "8057e75e35dd62e301ed413f8747470f5fc0937236aa47eec596798d6c230229",
}


def _leaf_array(path: str, shape: Tuple[int, ...], seed: int) -> np.ndarray:
    """The reference's float32 leaf at ``path`` (``params/a/b/kernel``)."""
    name = path.rsplit("/", 1)[-1]
    if "_zero" in path or name == "bias":
        return np.zeros(shape, np.float32)
    if name == "scale":
        return np.ones(shape, np.float32)
    rng = np.random.Generator(np.random.SFC64(
        int.from_bytes(hashlib.sha256(f"{seed}:{path}".encode()).digest()[:8], "big")))
    out = rng.standard_normal(shape, dtype=np.float32)
    if "embedding" in name or name == "cls_token":
        out *= np.float32(0.02)
    else:
        out *= np.float32(np.sqrt(1.0 / max(1, int(np.prod(shape[:-1])))))
    return out


def _dtype(dtype) -> Optional[torch.dtype]:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


@torch.no_grad()
def fast_init(module: nn.Module, seed: int,
              dtype: Union[str, torch.dtype, None] = None) -> nn.Module:
    """Set every parameter of ``module`` (one flax tree of the reference: a
    UNet3D, VideoDiT, text encoder, VAE decoder or encoder, vision tower) to
    the reference's ``fast_init`` draw at ``seed``, in place, on the
    parameter's device. ``dtype`` is the reference's cast (its
    ``params_dtype``); the value then takes the parameter's own dtype."""
    cast = _dtype(dtype)

    def draw(leaf):
        return torch.from_numpy(_leaf_array(leaf.key, leaf.shape, seed))

    for leaf, value in drawn(flax_leaves(module), draw):
        # float32 in the flax layout to the parameter's device, then the cast
        # (round to nearest even on either device) and the layout there
        value = value.to(leaf.param.device)
        leaf.param.copy_(leaf.to_torch(value if cast is None else value.to(cast)))
    return module


def drawn(items, draw):
    """(item, draw(item)) for each item in order, the draws run on
    DRAW_WORKERS threads a bounded number ahead of the consumer (the drawn
    leaves of an 11 B-parameter model would not fit the host at once)."""
    with ThreadPoolExecutor(max_workers=DRAW_WORKERS) as ex:
        pending = collections.deque()
        for item in items:
            pending.append((item, ex.submit(draw, item)))
            if len(pending) >= 2 * DRAW_WORKERS:
                done, fut = pending.popleft()
                yield done, fut.result()
        while pending:
            done, fut = pending.popleft()
            yield done, fut.result()


def param_count(obj) -> int:
    """Parameters of a module or pipeline (every flax leaf's size)."""
    return sum(leaf.param.numel() for leaf in flax_leaves(obj))


def param_bytes(obj) -> int:
    """Bytes of a module's or pipeline's parameters, in their dtypes."""
    return sum(leaf.param.numel() * leaf.param.element_size() for leaf in flax_leaves(obj))


def tree_digest(obj) -> str:
    """sha256 over every leaf's bytes in the flax layout, leaves in the
    reference's ``jax.tree.flatten`` order: equal to the same digest of the
    reference's ``Pipeline.params`` exactly when every leaf is bit-equal."""
    h = hashlib.sha256()
    for leaf in flax_leaves(obj):
        value = leaf.to_flax(leaf.param.detach()).contiguous().cpu()
        if value.dtype == torch.bfloat16:
            value = value.view(torch.int16)
        h.update(value.numpy().tobytes())
    return h.hexdigest()
