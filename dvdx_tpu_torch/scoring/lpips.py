"""LPIPS (AlexNet) perceptual distance, the MD-VQS video-quality metric.

Counterpart of ``dvdx_tpu/scoring/lpips.py``: the lpips package's 'alex'
network as an ``nn.Module`` computing in NCHW float32 on its device.
``utils.convert.load_lpips`` maps an lpips-package state dict
(``net.sliceK.*``, ``linN.model.1.weight``, ``scaling_layer.*``) onto it, and
``utils.bridge.load_lpips_params`` carries the JAX package's parameters in.

Architecture:
  scaling: x' = (x - shift) / scale   (x in [-1, 1])
  AlexNet features, a tap after each ReLU:
    conv0 3->64    k11 s4 p2 | relu | maxpool k3 s2
    conv1 64->192  k5 p2     | relu | maxpool k3 s2
    conv2 192->384 k3 p1     | relu
    conv3 384->256 k3 p1     | relu
    conv4 256->256 k3 p1     | relu
  per tap: unit-normalise the channels, (fa - fb)^2, a 1x1 ``lin`` head with
  non-negative weights, the spatial mean; the distance is the sum over the
  five taps.

The parameters carry the JAX package's names (``convK`` with ``weight`` /
``bias``, bare ``linK``), so a JAX parameter dict maps onto the module leaf
by leaf; its ``shift`` and ``scale`` are ``in_shift`` and ``in_scale`` here
(to the bridge, a leaf named ``scale`` is a norm's weight).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import span
from .common import as_device_u8

# the lpips package's ScalingLayer constants
LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
LPIPS_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# (out_ch, kernel, stride, pad, maxpool_after)
ALEX_LAYERS = [
    (64, 11, 4, 2, True),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, False),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
]


def _normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / torch.sqrt((x * x).sum(dim=1, keepdim=True) + eps)


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()

        def frozen(value) -> nn.Parameter:
            return nn.Parameter(torch.as_tensor(value, dtype=torch.float32).clone(),
                                requires_grad=False)

        self.in_shift = frozen(LPIPS_SHIFT)
        self.in_scale = frozen(LPIPS_SCALE)
        cin = 3
        for i, (cout, k, s, pad, _mp) in enumerate(ALEX_LAYERS):
            conv = nn.Conv2d(cin, cout, k, stride=s, padding=pad)
            conv.requires_grad_(False)
            setattr(self, f"conv{i}", conv)
            setattr(self, f"lin{i}", frozen(np.zeros(cout, np.float32)))
            cin = cout

    @classmethod
    def random(cls, seed: int = 0, device="cuda") -> "LPIPS":
        """The JAX package's ``LPIPS.random(seed)`` draws (numpy), for
        structure tests."""
        from ..utils.bridge import load_lpips_params

        rng = np.random.default_rng(seed)
        p = {"shift": LPIPS_SHIFT, "scale": LPIPS_SCALE}
        cin = 3
        for i, (cout, k, _s, _p, _mp) in enumerate(ALEX_LAYERS):
            p[f"conv{i}/kernel"] = rng.normal(
                0, (k * k * cin) ** -0.5, (k, k, cin, cout)).astype(np.float32)
            p[f"conv{i}/bias"] = np.zeros((cout,), np.float32)
            p[f"lin{i}"] = np.abs(rng.normal(0, 0.1, (cout,))).astype(np.float32)
            cin = cout
        return load_lpips_params(cls().to(device), p)

    @property
    def device(self) -> torch.device:
        return self.in_shift.device

    def taps(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: (N, 3, H, W) float32 in [-1, 1] -> the 5 unit-normalised taps."""
        h = (x - self.in_shift.view(1, 3, 1, 1)) / self.in_scale.view(1, 3, 1, 1)
        out = []
        for i, (*_, mp) in enumerate(ALEX_LAYERS):
            h = F.relu(getattr(self, f"conv{i}")(h))
            out.append(_normalize(h))
            if mp:
                h = F.max_pool2d(h, 3, 2)
        return out

    def _tap_distance(self, i: int, xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
        lin = getattr(self, f"lin{i}").view(1, -1, 1, 1)
        return (((xa - xb) ** 2) * lin).sum(dim=1).mean(dim=(1, 2))

    @torch.inference_mode()
    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a, b: (N, 3, H, W) float32 in [-1, 1] -> (N,) distances."""
        d = torch.zeros(a.shape[0], dtype=torch.float32, device=a.device)
        for i, (xa, xb) in enumerate(zip(self.taps(a), self.taps(b))):
            d = d + self._tap_distance(i, xa, xb)
        return d

    def _nchw(self, frames) -> torch.Tensor:
        x = torch.as_tensor(frames).to(self.device, torch.float32)
        return x.permute(0, 3, 1, 2)

    def distance(self, a, b) -> np.ndarray:
        """a, b: (N, H, W, 3) float32 in [-1, 1] (numpy or tensors) -> (N,)
        LPIPS distances."""
        return self(self._nchw(a), self._nchw(b)).cpu().numpy()

    def consecutive_mean(self, frames) -> float:
        """Mean LPIPS over consecutive frame pairs of (F, H, W, 3) float32
        frames in [-1, 1]."""
        if frames.shape[0] < 2:
            return 0.0
        return float(self.distance(frames[:-1], frames[1:]).mean())

    @torch.inference_mode()
    def consecutive_mean_u8(self, frames_uint8) -> float:
        """``consecutive_mean`` of uint8 frames (numpy, or a tensor on any
        device): one transfer to the module's device, the [-1, 1] conversion
        there, one feature pass per frame."""
        if frames_uint8.shape[0] < 2:
            return 0.0
        f = as_device_u8(frames_uint8, self.device).float() / 127.5 - 1.0
        taps = self.taps(f.permute(0, 3, 1, 2))
        d = torch.zeros(f.shape[0] - 1, dtype=torch.float32, device=f.device)
        for i, x in enumerate(taps):
            d = d + self._tap_distance(i, x[:-1], x[1:])
        d = d.mean()
        with span("wait.lpips_fetch"):
            return float(d)
