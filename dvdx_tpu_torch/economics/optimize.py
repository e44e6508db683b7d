"""Protocol parameter optimisation.

Reference: `Economics/core/parameter_optimisation.py` — a closed-form EV grid
search for protocol parameters. Here: find the CHEAPEST secure operating
point — the (alpha, f) minimising validator audit cost subject to
EV_cheat < EV_honest for every tamper strategy, at a given trust decay gamma.

This package's own copy of ``dvdx_tpu/economics/optimize.py``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .cost import d_min_grid
from .params import DEFAULT, EconParams
from .security import default_grid, simulate_ev


def audit_cost_per_job(params: EconParams, alpha: float) -> float:
    """Expected validator re-execution cost (TAO/job)."""
    return alpha * params.num_checkpoints * params.tao_per_step + params.gas_cost


def cheapest_secure_point(params: EconParams = DEFAULT, gamma: float = 0.8,
                          margin: float = 0.0, res: Optional[Dict] = None,
                          **sweep_kwargs) -> Dict[str, float]:
    """Minimise audit cost over the secure region at the given gamma.

    margin > 0 requires EV_cheat < EV_honest - margin (safety buffer).
    Returns the optimal (alpha, f), its audit cost, and D_min.
    """
    gammas, alphas, fs = default_grid()
    if res is None:
        res = simulate_ev(params, gamma=gammas, alpha=alphas, f=fs, **sweep_kwargs)
    gi = int(np.argmin(np.abs(res["gamma"] - gamma)))
    secure = res["delta"][gi] < -margin          # (A, F)
    if not secure.any():
        return {"feasible": False, "gamma": gamma}

    costs = np.array([audit_cost_per_job(params, a) for a in res["alpha"]])
    cost_grid = np.broadcast_to(costs[:, None], secure.shape).copy()
    cost_grid[~secure] = np.inf
    ai, _ = np.unravel_index(np.argmin(cost_grid), cost_grid.shape)
    # audit cost depends only on alpha; among secure f at the chosen alpha,
    # take the LARGEST slash fraction — maximal one-shot deterrence at equal
    # validator cost (f=0 would leave stake-slashing toothless)
    fi = int(np.max(np.nonzero(secure[ai])[0]))

    dmin = d_min_grid(params, res=res)
    return {
        "feasible": True,
        "gamma": float(gamma),
        "alpha": float(res["alpha"][ai]),
        "f": float(res["f"][fi]),
        "audit_cost_tao_per_job": float(costs[ai]),
        "delta_ev": float(res["delta"][gi, ai, fi]),
        "d_min_usd": float(dmin["d_min_usd"][gi, ai, fi]),
        "secure_fraction_at_gamma": float(secure.mean()),
    }


def min_checkpoints_secure(params: EconParams = DEFAULT, gamma: float = 0.8,
                           t_steps: int = 25, budget_fraction: float = 0.10,
                           margin: float = 0.0, k_floor: int = 2,
                           **sweep_kwargs) -> Dict[str, float]:
    """Smallest spot-check count k whose re-execution budget k/T stays within
    `budget_fraction` AND still admits a secure (alpha, f) region.

    This closes the verify-overhead loop (BASELINE '<10% spot-check
    overhead'): re-execution cost is exactly k UNet steps out of T, so at
    T=25 the reference default k=3 is 12% by arithmetic — no kernel can fix
    that. The economics, however, stay secure at smaller k because slashing
    + stake depletion dominate detection probability
    (`Economics/core/security_analysis.py:32-67` EV
    structure), so the validator can BUY the budget back with k=2 at T=25
    while EV_cheat < EV_honest holds for every tamper strategy.

    k_floor=2: the protocol needs the always-checked final step (video-trace
    binding) plus at least one interior sample to keep the hypergeometric
    detection live (network/validator._spot_check).

    Returns the chosen point dict (cheapest_secure_point fields) plus
    {"k": k, "verify_fraction": k / t_steps}; infeasible when even the
    largest k within budget admits no secure region.
    """
    import dataclasses as _dc

    k_max = max(k_floor, int(budget_fraction * t_steps))
    best: Dict[str, float] = {"feasible": False, "gamma": float(gamma)}
    for k in range(k_floor, k_max + 1):
        p = _dc.replace(params, num_checkpoints=k)
        pt = cheapest_secure_point(p, gamma=gamma, margin=margin,
                                   **sweep_kwargs)
        if pt.get("feasible"):
            pt["k"] = k
            pt["verify_fraction"] = k / float(t_steps)
            return pt
        best = pt
    return best
