"""The economics pipeline: ``python -m dvdx_tpu_torch econ``.

Counterpart of ``dvdx_tpu/economics/run.py``, with the same outputs: the
stage-1 EV sweep over the (gamma, alpha, f) grid, the stage-2 deposit
bounds, the sensitivity sweeps and the plots.

  python -m dvdx_tpu_torch econ --out economics_out [--paths 256] [--seed 0]
      [--skip-sensitivity]

writes ``results_stage1.npz``, ``results_stage2.npz``, ``summary.json`` and
the PNGs into ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .cost import d_min_grid, summarize
from .params import DEFAULT
from .security import run_stage1
from .sensitivity import cost_step_sensitivity, e_subnet_sensitivity
from .visualize import (plot_detection_curve, plot_dmin_heatmaps, plot_ev_heatmaps,
                        plot_sensitivity)


def _usd(v) -> str:
    return f"${v:.4f}" if v is not None else "n/a (no secure region)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dvdx_tpu_torch econ",
                                 description="dvdx economics pipeline")
    ap.add_argument("--out", default="economics_out")
    ap.add_argument("--paths", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-sensitivity", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    print("[stage1] EV sweep over (gamma, alpha, f) grid...")
    res = run_stage1(DEFAULT, out_path=os.path.join(args.out, "results_stage1.npz"),
                     n_paths=args.paths, seed=args.seed)
    sec = float((res["delta"] < 0).mean())
    print(f"  secure fraction of grid: {sec:.2%}")

    print("[stage2] deposit bounds...")
    cost = d_min_grid(DEFAULT, res=res)
    s = summarize(cost)
    print(f"  min D: {_usd(s['min_d_usd'])}  median D: {_usd(s['median_d_usd'])}")
    np.savez(os.path.join(args.out, "results_stage2.npz"), **cost)

    print("[plots] heatmaps + detection curve...")
    plot_ev_heatmaps(res, args.out, key="delta")
    plot_dmin_heatmaps(cost, args.out)
    plot_detection_curve(os.path.join(args.out, "detection_curve.png"), T=DEFAULT.num_steps)

    summary = {"stage1_secure_fraction": sec, **s}
    if not args.skip_sensitivity:
        print("[sensitivity] e_subnet / cost_step sweeps...")
        n = max(64, args.paths // 4)
        es = e_subnet_sensitivity(DEFAULT, n_paths=n)
        cs = cost_step_sensitivity(DEFAULT, n_paths=n)
        plot_sensitivity(es, "e_subnet", os.path.join(args.out, "sens_e_subnet.png"))
        plot_sensitivity(cs, "tao_per_step", os.path.join(args.out, "sens_cost.png"))
        summary["e_subnet_sensitivity"] = es
        summary["cost_sensitivity"] = cs

    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(f"done -> {args.out}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
