"""DDIM and DPM-Solver++(2M) schedule tables and their deterministic updates.

Counterpart of ``dvdx_tpu/ops/scheduler.py``: diffusers' DDIMScheduler with
scaled-linear betas, 'leading' spacing, steps_offset=1 and
set_alpha_to_one=False, which is what Zeroscope ships, for epsilon- and
v-prediction models (the CogVideoX-class DiT), and the DPM-Solver++(2M)
multistep sampler. ``make_ddim_schedule`` also takes the published
CogVideoX scheduler's settings (``CogVideoXDDIMScheduler``): trailing
spacing, alpha-bar rescaled to zero terminal SNR and ``set_alpha_to_one``;
its ``snr_shift_scale`` is 1.0 for the 5B model, the identity, and is not
taken. The tables are host numpy (float64 derivation, stored as
float32); a step is float32 math on the caller's device with the result cast
back to the latent dtype, which pins the bit pattern the Proof-of-Inference
leaves commit to.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Sampled-timestep tables for one (num_train_timesteps, num_steps).

    timesteps: (N,) int32, descending. alphas_cumprod: (N,) float32
    alpha-bar at each sampled timestep. alphas_cumprod_prev: (N,) float32
    alpha-bar at the next-visited timestep (alpha-bar[0] after the last)."""

    timesteps: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    prediction_type: str = "epsilon"

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def make_betas(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
               beta_end: float = 0.012,
               beta_schedule: str = "scaled_linear") -> np.ndarray:
    """Training beta schedule, float64."""
    if beta_schedule == "scaled_linear":
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                           num_train_timesteps, dtype=np.float64) ** 2
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps,
                           dtype=np.float64)
    raise ValueError(f"unknown beta_schedule {beta_schedule!r}")


def rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    """alpha-bar rescaled so that the last training timestep has zero SNR
    (arXiv:2305.08891, Algorithm 1; diffusers' ``rescale_zero_terminal_snr``
    on alpha-bar, as the CogVideoX scheduler applies it): sqrt(alpha-bar)
    shifted to end at exactly 0 and scaled to keep its first value."""
    s = np.sqrt(alphas_cumprod)
    s0, s_last = s[0], s[-1]
    s = (s - s_last) * (s0 / (s0 - s_last))
    return s ** 2


def make_ddim_schedule(num_steps: int, num_train_timesteps: int = 1000,
                       beta_start: float = 0.00085, beta_end: float = 0.012,
                       beta_schedule: str = "scaled_linear",
                       steps_offset: int = 1,
                       timestep_spacing: str = "leading",
                       prediction_type: str = "epsilon",
                       rescale_zero_snr: bool = False,
                       set_alpha_to_one: bool = False) -> DDIMSchedule:
    """The sampled-timestep tables; ``rescale_zero_snr`` rescales alpha-bar
    to zero terminal SNR, and ``set_alpha_to_one`` makes the alpha-bar after
    the last step 1 (else alpha-bar[0]). Both off give the zeroscope tables."""
    betas = make_betas(num_train_timesteps, beta_start, beta_end, beta_schedule)
    acp = np.cumprod(1.0 - betas)
    if rescale_zero_snr:
        acp = rescale_zero_terminal_snr(acp)
    if timestep_spacing == "leading":
        step_ratio = num_train_timesteps // num_steps
        ts = (np.arange(num_steps) * step_ratio).round().astype(np.int64)[::-1].copy()
        ts += steps_offset
    elif timestep_spacing == "trailing":
        step_ratio = num_train_timesteps / num_steps
        ts = np.round(np.arange(num_train_timesteps, 0, -step_ratio)).astype(np.int64) - 1
    else:
        raise ValueError(f"unknown timestep_spacing {timestep_spacing!r}")
    ts = np.clip(ts, 0, num_train_timesteps - 1)
    prev_ts = ts - num_train_timesteps // num_steps
    final = 1.0 if set_alpha_to_one else acp[0]
    alpha_prev = np.where(prev_ts >= 0, acp[np.clip(prev_ts, 0, None)], final)
    return DDIMSchedule(timesteps=ts.astype(np.int32),
                        alphas_cumprod=acp[ts].astype(np.float32),
                        alphas_cumprod_prev=alpha_prev.astype(np.float32),
                        prediction_type=prediction_type)


def _fma(a, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c with one float32 rounding: the float64 product of two
    float32 values is exact."""
    return (b.double() * float(a) + c.double()).float()


def ddim_step(sched: DDIMSchedule, step_index: int, latents: torch.Tensor,
              eps: torch.Tensor) -> torch.Tensor:
    """One deterministic (eta = 0) DDIM update z_t -> z_{t_prev}; ``eps`` is
    the model output, epsilon or v by the schedule's prediction type.

    float32 math, result cast back to the latent dtype. The scalars are
    float32 (square roots correctly rounded). For epsilon,
    ``z - sqrt(beta) * eps`` and the final ``sqrt(alpha_prev) * x0 +
    sqrt(1 - alpha_prev) * eps`` are fused multiply-adds, the evaluation
    XLA's CPU backend gives the reference. For v (v = sqrt(a) eps -
    sqrt(1 - a) x0): x0 = sqrt(a) z - sqrt(1 - a) v and eps = sqrt(a) v +
    sqrt(1 - a) z, each a fused multiply-add, as is the final sum (XLA fuses
them in the other order there)."""
    i = int(step_index)
    f32 = np.float32
    alpha_t = f32(sched.alphas_cumprod[i])
    alpha_prev = f32(sched.alphas_cumprod_prev[i])
    sqrt_beta = np.sqrt(f32(1.0) - alpha_t)
    sqrt_prev = np.sqrt(alpha_prev)
    sqrt_dir = np.sqrt(f32(1.0) - alpha_prev)
    z = latents.float()
    out = eps.float()
    if sched.prediction_type == "v_prediction":
        sqrt_alpha = np.sqrt(alpha_t)
        pred_x0 = _fma(sqrt_alpha, z, out * float(-sqrt_beta))
        e = _fma(sqrt_alpha, out, z * float(sqrt_beta))
        prev = _fma(sqrt_prev, pred_x0, e * float(sqrt_dir))
    elif sched.prediction_type == "epsilon":
        rsqrt_alpha = f32(1.0 / np.sqrt(np.float64(alpha_t)))
        pred_x0 = _fma(-sqrt_beta, out, z) * float(rsqrt_alpha)
        prev = _fma(sqrt_dir, out, pred_x0 * float(sqrt_prev))
    else:
        raise ValueError(f"unknown prediction_type {sched.prediction_type!r}")
    return prev.to(latents.dtype)


def ddim_step_from_timestep(sched: DDIMSchedule, t: int, latents: torch.Tensor,
                            eps: torch.Tensor) -> torch.Tensor:
    """DDIM step addressed by training timestep t (the validator knows the
    committed timesteps, not the loop index)."""
    hits = np.nonzero(sched.timesteps == int(t))[0]
    if hits.size == 0:
        raise ValueError(f"timestep {t} is not in the schedule")
    return ddim_step(sched, int(hits[0]), latents, eps)


@dataclasses.dataclass(frozen=True)
class DPMSchedule:
    """DPM-Solver++(2M) tables at the sampled timesteps, all (N,): timesteps
    int32 (descending), and float32 alpha-bar, lambda (log(alpha) -
    log(sigma)), sigma = sqrt(1 - alpha-bar) and alpha = sqrt(alpha-bar)."""

    timesteps: np.ndarray
    alphas_cumprod: np.ndarray
    lambdas: np.ndarray
    sigmas: np.ndarray
    alphas: np.ndarray

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def make_dpm_schedule(num_steps: int, num_train_timesteps: int = 1000,
                      beta_start: float = 0.00085,
                      beta_end: float = 0.012) -> DPMSchedule:
    acp = np.cumprod(1.0 - make_betas(num_train_timesteps, beta_start, beta_end))
    step_ratio = num_train_timesteps // num_steps
    ts = (np.arange(num_steps) * step_ratio).round().astype(np.int64)[::-1].copy() + 1
    ts = np.clip(ts, 0, num_train_timesteps - 1)
    a = np.sqrt(acp[ts])
    s = np.sqrt(1.0 - acp[ts])
    return DPMSchedule(timesteps=ts.astype(np.int32),
                       alphas_cumprod=acp[ts].astype(np.float32),
                       lambdas=(np.log(a) - np.log(s)).astype(np.float32),
                       sigmas=s.astype(np.float32), alphas=a.astype(np.float32))


def dpm_step(sched: DPMSchedule, step_index: int, latents: torch.Tensor,
             eps: torch.Tensor, prev_x0: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One DPM-Solver++(2M) update -> (z_prev, x0); feed x0 back as
    ``prev_x0`` on the next call (the first call is first order whatever it
    is given). The last step returns the clean x0 estimate. float32 math
    with fused multiply-adds, z_prev cast back to the latent dtype; within a
    few float32 ulps of the reference (XLA's own expm1 and division)."""
    i, n = int(step_index), sched.num_steps
    f32 = np.float32
    a_t, s_t, l_t = (f32(t[i]) for t in (sched.alphas, sched.sigmas, sched.lambdas))
    nxt = min(i + 1, n - 1)
    a_n, s_n, l_n = (f32(t[nxt]) for t in (sched.alphas, sched.sigmas, sched.lambdas))
    z = latents.float()
    x0 = _fma(-s_t, eps.float(), z) / float(a_t)
    if i == n - 1:
        return x0.to(latents.dtype), x0
    h = f32(l_n - l_t)
    if i == 0:
        d = x0
    else:
        r = f32(f32(l_t - f32(sched.lambdas[i - 1])) / (h if h != 0 else f32(1.0)))
        c = f32(f32(1.0) / (f32(2.0) * (r if r != 0 else f32(1.0))))
        d = _fma(f32(1.0) + c, x0, prev_x0.float() * -float(c))
    z_prev = _fma(f32(s_n / s_t), z, d * -float(f32(a_n * f32(np.expm1(-h)))))
    return z_prev.to(latents.dtype), x0
