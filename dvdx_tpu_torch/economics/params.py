"""Shared economic constants.

This package's own copy of ``dvdx_tpu/economics/params.py``: the protocol's
operating point (alpha* = 0.30 audit rate, f* = 0.10 slash fraction, gamma =
0.8 trust decay, s = 0.70 miner deposit split), the cost model (T = 30 steps
at 3.3 s/step on an A100 => 6.2e-6 TAO/step, gas 2e-4, subnet emission 5e-3
TAO/epoch) and the dynamics the security analysis simulates.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EconParams:
    # protocol operating point
    audit_rate: float = 0.30          # alpha*
    slash_fraction: float = 0.10      # f*
    trust_decay: float = 0.8          # gamma
    miner_split: float = 0.70         # s (deposit share to miners)

    # cost model
    num_steps: int = 30               # T denoise steps per job
    num_checkpoints: int = 3          # k spot checks per audited job
    tao_per_step: float = 6.2e-6      # A100 3.3 s/step cost in TAO
    gas_cost: float = 2e-4            # per-tx gas (TAO)
    e_subnet: float = 5e-3            # per-epoch subnet emission (TAO)
    miner_emission_share: float = 0.41
    job_margin: float = 1.2           # job payment = margin * honest compute

    # dynamics
    discount: float = 0.95            # beta per epoch
    honest_drift: float = 0.01        # eta: trust recovery per honest epoch
    kappa_limit: float = 0.1          # max normalised validator weight
    epochs: int = 60                  # K_CUT simulation horizon

    # stage-2 (user deposit bounds)
    miner_reward_split: float = 0.9   # s_miner within the reward pool
    validator_reward_split: float = 0.1
    tao_usd: float = 436.0


DEFAULT = EconParams()
