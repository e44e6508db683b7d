"""Stage-2 user-cost bounds: minimum viable deposit D_min.

Reference: `Economics/core/cost_analysis` (+ the embedded recomputation in
`core/e_subnet_sensitivity.py:148-163`): D_min = max(miner_term, val_need)
with reward splits s_miner=0.9 / s_val=0.1, evaluated only where EV_cheat < 0,
converted to USD at TAO=$436.

This package's own copy of ``dvdx_tpu/economics/cost.py``.

Model:
  miner_term — the miner pool share of the deposit must cover honest compute
               (T steps) + submission gas, with margin mu;
  val_need   — the validator share must cover its audit compute
               (expected alpha*k re-executed steps) + reward-distribution gas.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .params import DEFAULT, EconParams
from .security import default_grid, secure_region, simulate_ev


def d_min_grid(params: EconParams = DEFAULT, *, margin: float = 1.1,
               res: Optional[Dict[str, np.ndarray]] = None,
               **sweep_kwargs) -> Dict[str, np.ndarray]:
    """D_min over the (gamma, alpha, f) grid; +inf outside the secure region."""
    if res is None:
        gamma, alpha, f = default_grid()
        res = simulate_ev(params, gamma=gamma, alpha=alpha, f=f, **sweep_kwargs)
    gamma, alpha, f = res["gamma"], res["alpha"], res["f"]
    T = params.num_steps

    miner_cost = T * params.tao_per_step + params.gas_cost
    miner_term = margin * miner_cost / params.miner_reward_split

    k = params.num_checkpoints                   # spot checks per audit
    audit_steps = alpha * k                      # expected re-executed steps/job
    val_cost = audit_steps * params.tao_per_step + params.gas_cost
    val_need = margin * val_cost / params.validator_reward_split  # (A,)

    d_min = np.maximum(miner_term, val_need[None, :, None])
    d_min = np.broadcast_to(d_min, res["delta"].shape).copy()
    d_min[~secure_region(res)] = np.inf
    return {
        "gamma": gamma, "alpha": alpha, "f": f,
        "d_min_tao": d_min,
        "d_min_usd": d_min * params.tao_usd,
        "miner_term_tao": np.full_like(d_min, miner_term),
        "val_need_tao": np.broadcast_to(val_need[None, :, None], d_min.shape).copy(),
        "secure": secure_region(res),
    }


def summarize(out: Dict[str, np.ndarray]):
    """Summary dict; no-secure-cell sentinels are None (not inf) so the
    pipeline's summary.json stays strict-JSON-parseable — json.dump emits
    the non-standard token `Infinity` for float('inf')."""
    finite = np.isfinite(out["d_min_usd"])
    return {
        "secure_fraction": float(out["secure"].mean()),
        "min_d_usd": float(out["d_min_usd"][finite].min()) if finite.any() else None,
        "median_d_usd": float(np.median(out["d_min_usd"][finite])) if finite.any() else None,
    }
