"""MD-VQS video quality score and the authenticity checks.

Counterpart of ``dvdx_tpu/scoring/mdvqs.py``:

* authenticity: a video is refused as static or degenerate unless its frames'
  gray-histogram entropies and its consecutive-frame |diff| means (0-255
  scale) clear both the mean and the spread thresholds. The integer
  reductions (per-frame histograms, per-pair |diff| sums) run on the frames'
  device in int32 / int64, which is exact, and the host finishes in float64,
  so the statistics equal the numpy path's bit for bit;
* MD-VQS = alpha * PF + beta * VQ + gamma * TC: PF the CLIP prompt fidelity,
  VQ = 1 - the mean perceptual distance between consecutive frames
  (LPIPS(alex) where a ``scoring.lpips.LPIPS`` is given as ``lpips_metric``,
  else a 3-scale random-projection proxy of it, whose conv weights are JAX's
  threefry draws, reproduced by ``ops.rng``), TC = 1 - exp(-flow / 8) over
  the mean optical-flow magnitude (cv2 Farneback on frames at most 320
  pixels wide, or a gradient proxy where cv2 is absent).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

try:
    import cv2

    _HAS_CV2 = True
except ImportError:
    _HAS_CV2 = False

from ..ops import rng as rng_ops
from .clip_score import CLIPScorer
from .common import as_device_u8


def _mark(timings: dict, name: str, t0: float) -> float:
    now = time.perf_counter()
    timings[name] = round(now - t0, 4)
    return now


# --- authenticity -----------------------------------------------------------


def _gray_u8(frames_uint8: np.ndarray) -> np.ndarray:
    """uint8 channel-mean gray through an int32 sum (equal to
    ``frames.mean(-1).astype(uint8)``)."""
    s = frames_uint8.sum(axis=-1, dtype=np.int32)
    return (s // frames_uint8.shape[-1]).astype(np.uint8)


def _entropies_from_counts(counts: np.ndarray) -> np.ndarray:
    counts = counts.astype(np.float64)
    ent = []
    for hist in counts:
        p = hist / hist.sum()
        p = p[p > 0]
        ent.append(float(-(p * np.log2(p)).sum()))
    return np.asarray(ent)


def frame_entropies(frames_uint8: np.ndarray) -> np.ndarray:
    """Per-frame grayscale histogram entropy (bits), on the host."""
    g = _gray_u8(frames_uint8)
    return _entropies_from_counts(np.stack([np.bincount(img.reshape(-1), minlength=256)
                                            for img in g]))


@torch.inference_mode()
def auth_stats_device(frames_u8: torch.Tensor):
    """Per-frame gray histograms (F, 256) and per-pair |diff| sums (F-1,) of
    uint8 frames, as exact integer reductions on their device, returned as
    int64 numpy. The histogram is a compare-and-count per frame (no
    atomics, so it runs under deterministic-algorithm mode)."""
    x = frames_u8.to(torch.int32)
    g = x.sum(dim=-1) // frames_u8.shape[-1]
    levels = torch.arange(256, dtype=torch.int32, device=g.device)
    counts = torch.stack([(gf.reshape(-1, 1) == levels).sum(dim=0) for gf in g])
    diff_sums = (x[1:] - x[:-1]).abs().sum(dim=(1, 2, 3))
    return counts.cpu().numpy(), diff_sums.cpu().numpy()


def verify_video_authenticity(frames_uint8, min_entropy: float = 1.0,
                              min_diff: float = 0.01,
                              host_frames: Optional[np.ndarray] = None) -> dict:
    """Static / degenerate detection. ``frames_uint8`` is host numpy or a
    uint8 tensor; a tensor of at least 2 frames runs the integer reductions
    on its device (``auth_stats_device``). Frame diffs are on the 0-255
    scale; a video must clear the mean and the spread thresholds of both
    diffs and entropies (the spread thresholds need at least 2 diffs), and
    fewer than 2 frames is inauthentic. ``host_frames`` is the caller's host
    copy, read instead of a device fetch where the device path is not
    taken. Returns {authentic, entropy, entropy_std, mean_frame_diff,
    std_frame_diff}."""
    f, per_pair = int(frames_uint8.shape[0]), 1
    for s in frames_uint8.shape[1:]:
        per_pair *= int(s)
    use_dev = isinstance(frames_uint8, torch.Tensor) and f >= 2
    if use_dev:
        counts, diff_sums = auth_stats_device(frames_uint8)
        ents = _entropies_from_counts(counts)
        diffs = diff_sums.astype(np.float64) / per_pair
    else:
        if host_frames is not None:
            frames_uint8 = host_frames
        elif isinstance(frames_uint8, torch.Tensor):
            frames_uint8 = frames_uint8.cpu().numpy()
        ents = frame_entropies(frames_uint8)
    if f < 2:
        diffs = np.zeros((1,), np.float32)
        authentic = False
    else:
        if not use_dev:
            x16 = frames_uint8.astype(np.int16)
            diffs = np.abs(np.diff(x16, axis=0)).reshape(f - 1, -1).mean(axis=1)
        # the entropy-spread floor is min(1e-3, min_entropy), so
        # min_entropy = 0 turns the entropy axis off
        have_spread = diffs.size >= 2
        authentic = bool(
            ents.mean() >= min_entropy
            and (not have_spread or ents.std() >= min(1e-3, min_entropy))
            and diffs.mean() >= min_diff
            and (not have_spread or diffs.std() >= min_diff))
    return {"authentic": authentic, "entropy": float(ents.mean()),
            "entropy_std": float(ents.std()), "mean_frame_diff": float(diffs.mean()),
            "std_frame_diff": float(diffs.std())}


# --- perceptual distance (LPIPS-class proxy) --------------------------------


def _same_pad_stride2(h: torch.Tensor) -> torch.Tensor:
    """XLA's SAME padding of a 3x3, stride-2 convolution on NCHW: the total
    pad per axis is max((ceil(n / 2) - 1) * 2 + 3 - n, 0), the smaller half
    before. An even size pads 0 before and 1 after, which F.conv2d's
    symmetric padding cannot express."""
    pads = []
    for n in (h.shape[3], h.shape[2]):  # F.pad lists the last axis first
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(h, pads)


def percep_weights(device, channels=(3, 32, 32)) -> list:
    """The 3 scales' conv weights, OIHW float32: jax.random.normal(
    fold_in(key(12345), s), (3, 3, C, 32)) * 0.2, drawn with ``ops.rng``."""
    key = rng_ops.key(12345)
    return [(rng_ops.normal(rng_ops.fold_in(key, s), (3, 3, c, 32), device=device)
             * 0.2).permute(3, 2, 0, 1).contiguous()
            for s, c in enumerate(channels)]


@torch.inference_mode()
def perceptual_distance_pairs(frames: torch.Tensor) -> torch.Tensor:
    """Mean perceptual distance between consecutive frames. frames (F, H, W,
    3) float32 in [-1, 1] -> scalar, about 0 for identical frames and 1 for
    unrelated ones: per scale, tanh of a 3x3 stride-2 random conv,
    unit-normalised over channels, the squared feature distance summed over
    channels and averaged; the scales' sum divided by 2 * 3."""
    h = frames.permute(0, 3, 1, 2)
    d = torch.zeros((), dtype=torch.float32, device=frames.device)
    weights = percep_weights(frames.device)
    for w in weights:
        h = torch.tanh(F.conv2d(_same_pad_stride2(h), w, stride=2))
        x = h / torch.sqrt((h * h).sum(dim=1, keepdim=True) + 1e-8)
        d = d + ((x[:-1] - x[1:]) ** 2).sum(dim=1).mean()
    return d / (2.0 * len(weights))


# --- optical flow temporal consistency --------------------------------------


def mean_flow_magnitude(frames_uint8: np.ndarray, max_width: int = 320) -> float:
    """Mean optical-flow magnitude between consecutive frames, in native
    pixels per frame: cv2 Farneback on frames stride-sliced to at most
    ``max_width`` pixels wide (magnitudes scaled back), or, without cv2, a
    normalised temporal-gradient proxy."""
    if frames_uint8.shape[0] < 2:
        return 0.0
    src = np.asarray(frames_uint8)
    scale = 1.0
    w = src.shape[2]
    if w > max_width:
        stride = int(np.ceil(w / max_width))
        src = src[:, ::stride, ::stride]
        scale = float(stride)
    gray = _gray_u8(src)
    mags = []
    for i in range(len(gray) - 1):
        if _HAS_CV2:
            flow = cv2.calcOpticalFlowFarneback(gray[i], gray[i + 1], None, 0.5, 3,
                                                15, 3, 5, 1.2, 0)
            mags.append(scale * float(np.linalg.norm(flow, axis=-1).mean()))
        else:
            dt = gray[i + 1].astype(np.float32) - gray[i].astype(np.float32)
            gx = np.gradient(gray[i].astype(np.float32), axis=1)
            gy = np.gradient(gray[i].astype(np.float32), axis=0)
            denom = np.sqrt(gx ** 2 + gy ** 2) + 1.0
            mags.append(scale * float(np.abs(dt / denom).mean()))
    return float(np.mean(mags))


# --- MD-VQS -----------------------------------------------------------------


@dataclasses.dataclass
class MDVQS:
    """score = alpha * PF + beta * VQ + gamma * TC, 0 for an inauthentic
    video. TC maps the flow through 1 - exp(-flow / flow_scale): more motion
    scores higher, with an asymptote at 1."""

    clip_scorer: CLIPScorer
    alpha: float = 0.4
    beta: float = 0.3
    gamma: float = 0.3
    flow_scale: float = 8.0
    # LPIPS(alex) (``scoring.lpips.LPIPS``, from ``utils.convert.load_lpips``);
    # None scores VQ with the random-projection proxy
    lpips_metric: Optional[object] = None

    def score(self, frames_uint8: np.ndarray, prompt: str, auth: Optional[dict] = None,
              frames_dev: Optional[torch.Tensor] = None) -> dict:
        """``auth`` is the authenticity result where the caller has it;
        ``frames_dev`` the frames already on the scorer's device, shared by
        every program here."""
        timings: dict = {}
        t0 = time.perf_counter()
        if frames_dev is None:
            frames_dev = as_device_u8(frames_uint8, self.clip_scorer.device)
            t0 = _mark(timings, "device_put", t0)
        if auth is None:
            auth = verify_video_authenticity(frames_dev, host_frames=frames_uint8)
            t0 = _mark(timings, "authenticity", t0)
        pf = self.clip_scorer.score_video(frames_dev, prompt)
        timings["clip_pf"] = round(time.perf_counter() - t0, 4)

        t0 = time.perf_counter()
        if self.lpips_metric is not None:
            lp = self.lpips_metric.consecutive_mean_u8(frames_dev)
            metric = "lpips-alex"
        else:
            lp = (float(perceptual_distance_pairs(frames_dev.float() / 127.5 - 1.0))
                  if frames_uint8.shape[0] > 1 else 0.0)
            metric = "random-projection-proxy"
        vq = float(np.clip(1.0 - lp, 0.0, 1.0))
        timings["perceptual_vq"] = round(time.perf_counter() - t0, 4)

        t0 = time.perf_counter()
        flow = mean_flow_magnitude(frames_uint8)
        timings["flow_tc"] = round(time.perf_counter() - t0, 4)
        tc = float(1.0 - np.exp(-flow / self.flow_scale))

        total = self.alpha * pf + self.beta * vq + self.gamma * tc
        if not auth["authentic"]:
            total = 0.0
        return {"score": float(total), "prompt_fidelity": float(pf),
                "video_quality": vq, "temporal_consistency": tc,
                "flow_magnitude": flow, "perceptual_distance": lp,
                "perceptual_metric": metric,
                "timings_s": timings, **auth}
