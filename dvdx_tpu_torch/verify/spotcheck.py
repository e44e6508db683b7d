"""Spot-check re-execution of revealed steps: the validator's half of Proof
of Inference, single device.

Counterpart of ``dvdx_tpu/verify/spotcheck.py`` (its single-device
``StepEngine`` and the module-level checks). Miner and validator run the same
step program -- ``pipelines.text2video.cfg_denoise_step`` on the same
weights, one batch-1 latent per call -- so a revealed (z_i, eps_i, z_{i+1})
triple is checked by re-execution:

  eps_i'   = UNet_cfg(z_i, t_i, text(prompt))   must equal eps_i
  z_{i+1}' = ddim_step(z_i, eps_i')             must equal z_{i+1}

On one platform every kernel of the step has a fixed launch shape and no
atomics (and cuDNN / cuBLAS run their deterministic algorithms), so the
re-execution reproduces the leaves bit for bit. Across platforms (a CUDA
miner, a CPU validator, or the JAX package on either side) the check is a
tolerance: the engine's ``platform_tag`` is what a miner pins, and the
validator picks its regime from it. The tag names the implementation as well
as the device ("torch-cuda", "torch-cpu"), so a JAX validator, whose own
tags are its backend names ("cpu", "tpu"), never takes a torch miner for one
of its own programs; it holds no ":", which the validators read as the start
of a strategy name.

Leaves are bfloat16 in channel-last (F, h, w, C) layout. numpy has no
bfloat16 of its own, so the engine hands them out as bfloat16 CPU tensors
(the ``verify.merkle`` leaf format); the checks take those or numpy arrays,
including the JAX package's ``ml_dtypes`` bfloat16 arrays, read by their
bytes. Mesh and chunked execution are not ported.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import rng as rng_ops
from ..ops.scheduler import ddim_step, make_ddim_schedule
from ..pipelines.text2video import Pipeline, cfg_denoise_step, generate_core, to_uint8
from ..utils.bridge import to_tensor
from .proof import sample_distinct_indices


def _tmark(timings: Optional[dict], name: str, t0: float) -> float:
    now = time.perf_counter()
    if timings is not None:
        timings[name] = round(now - t0, 4)
    return now


class StepEngine:
    """The prover / verifier step program of a ``Pipeline`` on its device."""

    def __init__(self, pipeline: Pipeline):
        self.pipe = pipeline

    @property
    def platform_tag(self) -> str:
        """What this engine's miner pins at registration: "torch-cuda" on
        the card, "torch-cpu" on the CPU. The CUDA kernels are built for
        sm_90a alone, so "torch-cuda" is always a Hopper card."""
        kind = self.pipe.device.type
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"StepEngine: unsupported device {self.pipe.device}")
        return f"torch-{kind}"

    def _schedule(self, num_steps: int):
        return make_ddim_schedule(num_steps, prediction_type=self.pipe.spec.prediction_type)

    def _encode(self, prompt: str, negative_prompt: str):
        """(uncond, cond) text states, from the same (2, S) encoder call
        generation makes."""
        ids = torch.from_numpy(self.pipe.tokenize([negative_prompt, prompt])).long()
        hidden, _ = self.pipe.text_encoder(ids.to(self.pipe.device))
        return hidden[0:1], hidden[1:2]

    # -- prover path --

    @torch.inference_mode()
    def generate_recorded(self, prompt: str, *, negative_prompt: str = "",
                          seed: int = 0, num_frames: int, height: int, width: int,
                          num_steps: int, guidance_scale: float,
                          latent_dtype: torch.dtype = torch.bfloat16,
                          segment_steps: int = 5, cfg_split: bool = False,
                          timings: Optional[dict] = None):
        """PoI-grade generation through the step program the verifier runs,
        driven in segments of ``segment_steps`` steps (``generate_core``: the
        leaves are the same bits whatever the segment length). Returns
        (video (F, H, W, 3) uint8 numpy, zs, epss, timesteps): zs and epss
        are (N, F, h, w, C) CPU tensors in latent_dtype, timesteps (N,)
        int32 numpy. ``timings`` (optional dict) receives host seconds per
        phase: "dispatch_loop" (text, noise, the denoise loop and the decode
        handed to the device), "compute_wall" (until the device is done),
        "leaf_fetch" and "video_fetch" (the copies to the host)."""
        t0 = time.perf_counter()
        sched = self._schedule(num_steps)
        ids = torch.from_numpy(self.pipe.tokenize([negative_prompt, prompt])).long()
        frames, zs, epss = generate_core(
            self.pipe, ids.to(self.pipe.device), rng_ops.base_key(seed), sched=sched,
            num_frames=num_frames, height=height, width=width,
            guidance_scale=guidance_scale, record=True, latent_dtype=latent_dtype,
            cfg_split=cfg_split, segment_steps=segment_steps)
        video = to_uint8(frames)
        t0 = _tmark(timings, "dispatch_loop", t0)
        if video.is_cuda:
            torch.cuda.current_stream(video.device).synchronize()
        t0 = _tmark(timings, "compute_wall", t0)
        zs, epss = zs[:, 0].cpu(), epss[:, 0].cpu()
        t0 = _tmark(timings, "leaf_fetch", t0)
        video = video.cpu().numpy()
        _tmark(timings, "video_fetch", t0)
        return video, zs, epss, sched.timesteps.copy()

    # -- verifier path --

    def _step(self, z_i, step_index: int, sched, cond, uncond,
              guidance_scale: float, cfg_split: bool):
        z = as_tensor(z_i).to(self.pipe.device)[None]
        z_next, eps = cfg_denoise_step(self.pipe.unet, sched, z, step_index, cond,
                                       uncond, guidance_scale, cfg_split=cfg_split)
        return eps[0].cpu(), z_next[0].cpu()

    @torch.inference_mode()
    def reexecute_pair(self, prompt: str, negative_prompt: str, z_i,
                       step_index: int, num_steps: int, guidance_scale: float,
                       cfg_split: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (eps_i', z_{i+1}') recomputed from z_i (F, h, w, C)."""
        uncond, cond = self._encode(prompt, negative_prompt)
        return self._step(z_i, step_index, self._schedule(num_steps), cond, uncond,
                          guidance_scale, cfg_split)

    @torch.inference_mode()
    def reexecute_steps(self, prompt: str, negative_prompt: str, z_list: Sequence,
                        step_indices: Sequence[int], num_steps: int,
                        guidance_scale: float, cfg_split: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """All k sampled steps after one text encode, one batch-1 step each
        (the same call generation makes) -> (eps' (k, ...), z_next' (k, ...))."""
        uncond, cond = self._encode(prompt, negative_prompt)
        sched = self._schedule(num_steps)
        out = [self._step(z, i, sched, cond, uncond, guidance_scale, cfg_split)
               for z, i in zip(z_list, step_indices)]
        return torch.stack([e for e, _ in out]), torch.stack([z for _, z in out])

    @torch.inference_mode()
    def decode_frame(self, z_frame) -> np.ndarray:
        """Decode one latent frame (h, w, C) -> (H, W, 3) float32 numpy in
        [-1, 1], through the per-frame call generation's decode makes."""
        z = as_tensor(z_frame).to(self.pipe.device).float()[None]
        return self.pipe.vae_decoder(z)[0].cpu().numpy()

    def verify_video_binding(self, video_frames: np.ndarray,
                             last_leaf: Tuple[int, object, object],
                             last_index: int, num_steps: int,
                             guidance_scale: float, prompt: str,
                             negative_prompt: str = "",
                             frame_indices: Sequence[int] = (0,),
                             max_err: float = 0.12) -> Tuple[bool, float]:
        """Bind the delivered video to the committed trace: re-derive z_final
        from the revealed last leaf (ddim_step on the engine's device, as
        generation takes it), decode the frames at ``frame_indices`` and
        compare each, 4x average-pooled, against the delivered frame.
        Returns (all_ok, worst mean absolute error)."""
        if last_index != num_steps - 1:
            raise ValueError("video binding requires the final leaf (T-1); "
                             "the final eps must also be re-executed so a "
                             "forged eps_{T-1} cannot bind a substitute video")
        _t, z_last, eps_last = last_leaf
        dev = self.pipe.device
        z_next = ddim_step(self._schedule(num_steps), last_index,
                           as_tensor(z_last).to(dev)[None],
                           as_tensor(eps_last).to(dev)[None])[0]

        def pool(x, k=4):
            h, w, c = x.shape
            h2, w2 = h - h % k, w - w % k
            return x[:h2, :w2].reshape(h2 // k, k, w2 // k, k, c).mean((1, 3))

        # the delivered video's frame count is miner-controlled: a short
        # video fails the binding
        if len(video_frames) < z_next.shape[0]:
            return False, float("inf")
        worst = 0.0
        for frame_idx in frame_indices:
            decoded = self.decode_frame(z_next[frame_idx])
            got = video_frames[frame_idx].astype(np.float32) / 127.5 - 1.0
            if decoded.shape != got.shape:
                return False, float("inf")
            err = float(np.mean(np.abs(pool(decoded) - pool(got))))
            worst = max(worst, err)
            if err > max_err:
                return False, worst
        return True, worst

    @torch.inference_mode()
    def base_latent(self, seed: int, num_frames: int, height: int, width: int,
                    latent_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """The miner's base noise re-derived from the 64-bit seed, on the
        engine's device as generation draws it -> (F, h, w, C) CPU tensor."""
        spec = self.pipe.spec
        ds = spec.vae.downscale
        noise = rng_ops.video_noise(rng_ops.base_key(seed), num_frames,
                                    (height // ds, width // ds, spec.latent_channels),
                                    device=self.pipe.device)
        return noise.to(latent_dtype).cpu()


@dataclasses.dataclass
class CheckResult:
    passed: bool
    reason: str = ""
    max_eps_err: float = 0.0
    max_z_err: float = 0.0
    bitwise: bool = False


def as_tensor(x) -> torch.Tensor:
    """A leaf as a CPU tensor: torch tensors as they are, numpy arrays
    (ml_dtypes bfloat16 included, by their bytes) copied."""
    return x.detach().cpu() if isinstance(x, torch.Tensor) else to_tensor(x)


def _bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()


def compare_arrays(got, expected, *, bitwise: bool, atol: float,
                   rtol: float = 0.0) -> Tuple[bool, float, bool]:
    """-> (ok, max_abs_err, was_bitwise).

    Identical bytes pass with was_bitwise=True. Otherwise each element is
    judged against atol + rtol * |expected| in float32: with bitwise=True
    (same platform) that is the validator's calibrated same-program bound,
    with bitwise=False the cross-platform tolerance."""
    a, b = as_tensor(got), as_tensor(expected)
    if tuple(a.shape) != tuple(b.shape):
        return False, float("inf"), False
    if _bytes(a) == _bytes(b):
        return True, 0.0, True
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    err = float(diff.max())
    ok = bool((diff <= atol + rtol * b.abs()).all())
    return ok, err, False


def binding_frame_indices(audit_secret: bytes, merkle_root: bytes,
                          num_frames: int, k: int = 2) -> List[int]:
    """Video-binding frame indices from the post-commit audit secret: k
    distinct frames, unpredictable at commit time."""
    return sample_distinct_indices(b"frame", audit_secret + merkle_root, num_frames, k)


def verify_revealed_steps(
    engine: StepEngine, prompt: str, negative_prompt: str,
    leaves: Dict[int, Tuple[int, object, object]], checks: Sequence[int],
    num_steps: int, guidance_scale: float, *, same_platform: bool,
    atol: float = 5e-2, rtol: float = 0.0, cfg_split: bool = False,
) -> Tuple[Dict[int, CheckResult], torch.Tensor]:
    """Re-execute every sampled step after one text encode. A step that
    fails is re-verified with the single-step path before it is declared a
    cheat. Returns ({step_index: CheckResult}, z_next_re (k, ...))."""
    checks = list(checks)
    eps_re, z_next_re = engine.reexecute_steps(
        prompt, negative_prompt, [leaves[i][1] for i in checks], checks,
        num_steps, guidance_scale, cfg_split=cfg_split)
    results: Dict[int, CheckResult] = {}
    for row, i in enumerate(checks):
        _t, _z_i, eps_i = leaves[i]
        ok_e, err_e, bit_e = compare_arrays(eps_re[row], eps_i, bitwise=same_platform,
                                            atol=atol, rtol=rtol)
        ok_z, err_z, bit_z = True, 0.0, True
        if i + 1 in leaves:
            ok_z, err_z, bit_z = compare_arrays(z_next_re[row], leaves[i + 1][1],
                                                bitwise=same_platform, atol=atol,
                                                rtol=rtol)
        if ok_e and ok_z:
            results[i] = CheckResult(True, "ok", err_e, err_z, bit_e and bit_z)
            continue
        results[i] = verify_revealed_step(
            engine, prompt, negative_prompt, leaves[i], i, num_steps,
            guidance_scale, same_platform=same_platform, atol=atol, rtol=rtol,
            next_leaf=leaves.get(i + 1), cfg_split=cfg_split)
    return results, z_next_re


def verify_revealed_step(engine: StepEngine, prompt: str, negative_prompt: str,
                         leaf_i: Tuple[int, object, object], step_index: int,
                         num_steps: int, guidance_scale: float, *,
                         same_platform: bool,
                         next_leaf: Optional[Tuple[int, object, object]] = None,
                         atol: float = 5e-2, rtol: float = 0.0,
                         cfg_split: bool = False) -> CheckResult:
    """Full re-execution check of sampled step i: eps_i always, z_{i+1} too
    when next_leaf (step i + 1) is given."""
    _t_i, z_i, eps_i = leaf_i
    eps_re, z_next_re = engine.reexecute_pair(prompt, negative_prompt, z_i, step_index,
                                              num_steps, guidance_scale,
                                              cfg_split=cfg_split)
    ok_e, err_e, bit_e = compare_arrays(eps_re, eps_i, bitwise=same_platform,
                                        atol=atol, rtol=rtol)
    if not ok_e:
        return CheckResult(False, "eps re-execution mismatch", err_e, 0.0, bit_e)
    if next_leaf is None:
        return CheckResult(True, "ok", err_e, 0.0, bit_e)
    ok_z, err_z, bit_z = compare_arrays(z_next_re, next_leaf[1], bitwise=same_platform,
                                        atol=atol, rtol=rtol)
    if not ok_z:
        return CheckResult(False, "z_{t+1} re-derivation mismatch", err_e, err_z, bit_z)
    return CheckResult(True, "ok", err_e, err_z, bit_e and bit_z)
