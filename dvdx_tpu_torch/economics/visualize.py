"""Heatmaps and sensitivity plots of the economics results.

This package's own copy of ``dvdx_tpu/economics/visualize.py``: offline
analysis that reads result dicts and writes PNGs. matplotlib is imported
when a plot is drawn, not with the module.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(plt, fig, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_ev_heatmaps(res: Dict[str, np.ndarray], out_dir: str,
                     key: str = "delta") -> List[str]:
    """One (alpha, f) heatmap per gamma of EV_cheat - EV_honest (or ``key``)."""
    plt = _plt()
    paths = []
    for gi, g in enumerate(res["gamma"]):
        fig, ax = plt.subplots(figsize=(6, 4.5))
        im = ax.imshow(res[key][gi], origin="lower", aspect="auto", cmap="RdYlGn_r",
                       extent=[res["f"][0], res["f"][-1], res["alpha"][0], res["alpha"][-1]])
        ax.set_xlabel("slash fraction f")
        ax.set_ylabel("audit rate alpha")
        ax.set_title(f"{key} (gamma={g:.1f}); red = cheating profitable")
        fig.colorbar(im, ax=ax)
        paths.append(_save(plt, fig, os.path.join(out_dir, f"{key}_gamma{g:.1f}.png")))
    return paths


def plot_dmin_heatmaps(cost: Dict[str, np.ndarray], out_dir: str) -> List[str]:
    plt = _plt()
    paths = []
    for gi, g in enumerate(cost["gamma"]):
        fig, ax = plt.subplots(figsize=(6, 4.5))
        im = ax.imshow(np.ma.masked_invalid(cost["d_min_usd"][gi]), origin="lower",
                       aspect="auto", cmap="viridis",
                       extent=[cost["f"][0], cost["f"][-1],
                               cost["alpha"][0], cost["alpha"][-1]])
        ax.set_xlabel("slash fraction f")
        ax.set_ylabel("audit rate alpha")
        ax.set_title(f"D_min USD (gamma={g:.1f}); blank = insecure region")
        fig.colorbar(im, ax=ax)
        paths.append(_save(plt, fig, os.path.join(out_dir, f"dmin_usd_gamma{g:.1f}.png")))
    return paths


def plot_sensitivity(rows: List[dict], x_key: str, out_path: str,
                     y_keys: Optional[List[str]] = None) -> str:
    """One panel per y key over ``x_key``; a row with no secure region
    (None) is drawn as a gap."""
    plt = _plt()
    y_keys = y_keys or ["secure_fraction", "median_d_usd"]
    fig, axes = plt.subplots(1, len(y_keys), figsize=(5 * len(y_keys), 4))
    axes = [axes] if len(y_keys) == 1 else axes
    xs = [r[x_key] for r in rows]
    for ax, yk in zip(axes, y_keys):
        ax.plot(xs, [float("nan") if r[yk] is None else r[yk] for r in rows], marker="o")
        ax.set_xlabel(x_key)
        ax.set_ylabel(yk)
        ax.grid(alpha=0.3)
    return _save(plt, fig, out_path)


def plot_detection_curve(out_path: str, T: int = 30, ks=(3, 6, 9)) -> str:
    """P(detect) against the tampered steps m, for several audit sizes k."""
    from .security import p_detect

    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    ms = np.arange(0, T + 1)
    for k in ks:
        ax.plot(ms, p_detect(T, ms, k), label=f"k={k}")
    ax.set_xlabel("tampered steps m")
    ax.set_ylabel("P(detect)")
    ax.legend()
    ax.grid(alpha=0.3)
    return _save(plt, fig, out_path)
