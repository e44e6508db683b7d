"""DDIM schedule tables and the deterministic DDIM update.

Counterpart of ``dvdx_tpu/ops/scheduler.py`` (its DDIM part): diffusers'
DDIMScheduler with scaled-linear betas, 'leading' spacing, steps_offset=1 and
set_alpha_to_one=False, which is what Zeroscope ships. The tables are host
numpy (float64 derivation, stored as float32); the step is float32 math on
the caller's device with the result cast back to the latent dtype, which pins
the bit pattern the Proof-of-Inference leaves commit to.
"""

from __future__ import annotations

import dataclasses

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


def make_ddim_schedule(num_steps: int, num_train_timesteps: int = 1000,
                       beta_start: float = 0.00085, beta_end: float = 0.012,
                       beta_schedule: str = "scaled_linear",
                       steps_offset: int = 1,
                       timestep_spacing: str = "leading",
                       prediction_type: str = "epsilon") -> DDIMSchedule:
    betas = make_betas(num_train_timesteps, beta_start, beta_end, beta_schedule)
    acp = np.cumprod(1.0 - betas)
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
    alpha_prev = np.where(prev_ts >= 0, acp[np.clip(prev_ts, 0, None)], acp[0])
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
    """One deterministic (eta = 0) DDIM update z_t -> z_{t_prev}.

    float32 math, result cast back to the latent dtype. The scalars are
    float32 (square roots correctly rounded); ``z - sqrt(beta) * eps`` and the
    final ``sqrt(alpha_prev) * x0 + sqrt(1 - alpha_prev) * eps`` are fused
    multiply-adds, the evaluation XLA's CPU backend gives the reference."""
    if sched.prediction_type != "epsilon":
        raise NotImplementedError("the port's DDIM step is epsilon-prediction only")
    i = int(step_index)
    f32 = np.float32
    alpha_t = f32(sched.alphas_cumprod[i])
    alpha_prev = f32(sched.alphas_cumprod_prev[i])
    sqrt_beta = np.sqrt(f32(1.0) - alpha_t)
    rsqrt_alpha = f32(1.0 / np.sqrt(np.float64(alpha_t)))
    sqrt_prev = np.sqrt(alpha_prev)
    sqrt_dir = np.sqrt(f32(1.0) - alpha_prev)
    z = latents.float()
    e = eps.float()
    pred_x0 = _fma(-sqrt_beta, e, z) * float(rsqrt_alpha)
    prev = _fma(sqrt_dir, e, pred_x0 * float(sqrt_prev))
    return prev.to(latents.dtype)


def ddim_step_from_timestep(sched: DDIMSchedule, t: int, latents: torch.Tensor,
                            eps: torch.Tensor) -> torch.Tensor:
    """DDIM step addressed by training timestep t (the validator knows the
    committed timesteps, not the loop index)."""
    hits = np.nonzero(sched.timesteps == int(t))[0]
    if hits.size == 0:
        raise ValueError(f"timestep {t} is not in the schedule")
    return ddim_step(sched, int(hits[0]), latents, eps)
