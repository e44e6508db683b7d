"""Sensitivity sweeps over the emission and compute-cost assumptions.

This package's own copy of ``dvdx_tpu/economics/sensitivity.py``: Stage-1
security and Stage-2 deposit bounds recomputed over E_SUBNET in
{.003, .005, .007, .010} and the cost per step in {4e-6 .. 1e-5}.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

from .cost import d_min_grid, summarize
from .params import DEFAULT, EconParams
from .security import default_grid, simulate_ev

E_SUBNET_GRID = (0.003, 0.005, 0.007, 0.010)
COST_STEP_GRID = (4e-6, 6e-6, 8e-6, 1e-5)


def _run_point(params: EconParams, **kwargs) -> Dict[str, float]:
    gamma, alpha, f = default_grid()
    res = simulate_ev(params, gamma=gamma, alpha=alpha, f=f, **kwargs)
    s = summarize(d_min_grid(params, res=res))
    s["max_delta"] = float(res["delta"].max())
    s["min_delta"] = float(res["delta"].min())
    return s


def e_subnet_sensitivity(base: EconParams = DEFAULT, grid: Sequence[float] = E_SUBNET_GRID,
                         **kwargs) -> List[Dict[str, float]]:
    return [{**_run_point(dataclasses.replace(base, e_subnet=e), **kwargs), "e_subnet": e}
            for e in grid]


def cost_step_sensitivity(base: EconParams = DEFAULT, grid: Sequence[float] = COST_STEP_GRID,
                          **kwargs) -> List[Dict[str, float]]:
    return [{**_run_point(dataclasses.replace(base, tao_per_step=c), **kwargs),
             "tao_per_step": c} for c in grid]
