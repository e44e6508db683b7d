"""Stage-1 security analysis: expected value of cheating vs honest mining.

This package's own copy of ``dvdx_tpu/economics/security.py`` (numpy and
scipy only). Monte-Carlo EV over a (gamma, alpha, f) grid with hypergeometric
spot-check detection p_detect(T, m, k) = 1 - C(T-m, k) / C(T, k), a
K_CUT = 60-epoch loop with stake slashing, trust decay on caught and honest
drift eta, discounted (beta = 0.95) with a geometric tail, and the worst case
over the number of tampered steps m. A single miner's EV: the kappa-clipped
validator weight matrix reduces to the trust-scaled emission share;
``kappa_clip`` is exported for the multi-miner weight computation. The epoch
loop is one numpy program over (grid cells x tampered-step counts x
Monte-Carlo paths), deterministically seeded.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
from scipy.special import gammaln

from .params import DEFAULT, EconParams


def p_detect(T: int, m, k) -> np.ndarray:
    """P(at least one of k uniform spot checks hits one of m tampered steps).
    Hypergeometric: 1 - C(T-m, k)/C(T, k). Vectorised over m and k."""
    m = np.asarray(m, np.float64)
    k = np.asarray(k, np.float64)

    def log_comb(n, r):
        n = np.asarray(n, np.float64)
        valid = (r >= 0) & (r <= n)
        out = gammaln(n + 1) - gammaln(r + 1) - gammaln(np.maximum(n - r, 0) + 1)
        return np.where(valid, out, -np.inf)

    log_miss = log_comb(T - m, k) - log_comb(T, k)
    p = 1.0 - np.exp(log_miss)
    return np.clip(p, 0.0, 1.0)


def kappa_clip(weights: np.ndarray, limit: float) -> np.ndarray:
    """Clip normalised weights at `limit` and renormalise (the validator
    weight normalisation of base/utils/weight_utils.py, used by the epoch
    model)."""
    w = np.clip(weights, 0.0, None)
    s = w.sum(axis=-1, keepdims=True)
    w = np.where(s > 0, w / np.where(s > 0, s, 1), w)
    for _ in range(8):
        over = w > limit
        if not over.any():
            break
        excess = np.where(over, w - limit, 0.0).sum(axis=-1, keepdims=True)
        w = np.where(over, limit, w)
        under_sum = np.where(~over, w, 0.0).sum(axis=-1, keepdims=True)
        w = np.where(~over & (under_sum > 0), w + excess * w / np.where(under_sum > 0, under_sum, 1), w)
    return w


def simulate_ev(
    params: EconParams = DEFAULT,
    *,
    gamma: np.ndarray,
    alpha: np.ndarray,
    f: np.ndarray,
    stake_tao: float = 0.5,
    n_paths: int = 256,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Monte-Carlo EVs on the full (gamma, alpha, f) grid.

    Returns dict with:
      ev_cheat:  (G, A, F) discounted EV of the *best* cheating strategy
                 (max over tampered-step count m in 1..T)
      ev_honest: scalar-broadcast (G, A, F) honest EV
      best_m:    (G, A, F) optimal tampered-step count
      delta:     ev_cheat - ev_honest (secure region: delta < 0)
    """
    T = params.num_steps
    G, A, F = len(gamma), len(alpha), len(f)
    ms = np.arange(1, T + 1)                       # (M,)
    k = params.num_checkpoints                     # spot checks per audit

    # catch prob per (alpha, m): validator audits a job w.p. alpha, and an
    # audit detects m tampered steps w.p. p_detect(T, m, k) — exactly our
    # protocol's (audit_rate, num_checkpoints) knobs in ValidatorConfig.
    p = np.asarray(alpha)[:, None] * p_detect(T, ms[None, :], k)   # (A, M)

    rng = np.random.default_rng(seed)
    epochs = params.epochs
    beta = params.discount

    cost_step = params.tao_per_step
    # per-job user payment (miner pool share of the deposit) and background
    # emission ~ trust-weighted validator weight
    p_job = params.job_margin * T * cost_step
    r_emit = params.e_subnet * params.miner_emission_share

    # honest EV (deterministic): paid every job, trust 1 throughout
    honest_epoch = p_job + r_emit - T * cost_step
    disc = beta ** np.arange(epochs)
    tail = beta**epochs / (1 - beta)
    ev_honest = honest_epoch * (disc.sum() + tail)

    # Monte-Carlo cheat EV over (G, A, F, M, paths)
    # vectorised epoch loop; memory bounded by chunking over gamma
    f_b = np.asarray(f)[None, :, None, None]
    comp_cost = (T - ms)[None, None, :, None] * cost_step
    ev_cheat = np.empty((G, A, F, len(ms)))
    for gi, g in enumerate(gamma):
        trust = np.ones((A, F, len(ms), n_paths))
        # stake depletes as it is slashed (reference `stake += reward -
        # pd*f*stake`, security_analysis.py:55) — a flat f*stake_0 per catch
        # would let cumulative slashes exceed the stake and overstate the
        # deterrent, inflating the secure region
        stake_path = np.full_like(trust, stake_tao)
        value = np.zeros_like(trust)
        for e in range(epochs + 1):
            caught = rng.random(trust.shape) < p[:, None, :, None]
            emit = r_emit * np.minimum(trust, 1.0)
            slash_now = f_b * stake_path
            # caught: job payment withheld (scored 0), stake slashed;
            # undetected: paid like an honest miner, saved m steps of compute
            epoch_val = np.where(caught, emit - comp_cost - slash_now,
                                 p_job + emit - comp_cost)
            w = tail if e == epochs else beta**e
            value += w * epoch_val
            stake_path = np.where(caught, stake_path - slash_now, stake_path)
            # reference decay: a caught miner KEEPS (1-gamma) of its trust
            # (`W[:,caught] *= (1-gamma)`, security_analysis.py:57) — gamma
            # is the fraction REMOVED, so gamma=0.8 is strong deterrence
            trust = np.where(caught, trust * (1.0 - g),
                             np.minimum(1.0, trust + params.honest_drift))
        ev_cheat[gi] = value.mean(axis=-1)

    best_m_idx = np.argmax(ev_cheat, axis=-1)
    ev_cheat_best = np.max(ev_cheat, axis=-1)
    return {
        "gamma": np.asarray(gamma),
        "alpha": np.asarray(alpha),
        "f": np.asarray(f),
        "ev_cheat": ev_cheat_best,
        "ev_honest": np.full((G, A, F), ev_honest),
        "best_m": ms[best_m_idx],
        "delta": ev_cheat_best - ev_honest,
        "ev_cheat_by_m": ev_cheat,
    }


def default_grid() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The reference sweep grid (security_analysis.py:70-77):
    gamma in {0, .5, .8, 1}, alpha in [.1,.6] x11, f in [0,.6] x13."""
    return (np.array([0.0, 0.5, 0.8, 1.0]),
            np.linspace(0.1, 0.6, 11),
            np.linspace(0.0, 0.6, 13))


def run_stage1(params: EconParams = DEFAULT, out_path: Optional[str] = None,
               **kwargs) -> Dict[str, np.ndarray]:
    gamma, alpha, f = default_grid()
    res = simulate_ev(params, gamma=gamma, alpha=alpha, f=f, **kwargs)
    if out_path:
        np.savez(out_path, **{k: v for k, v in res.items()})
    return res


def secure_region(res: Dict[str, np.ndarray]) -> np.ndarray:
    """Boolean (G, A, F) mask where cheating has negative expected advantage."""
    return res["delta"] < 0
