"""Plot helpers for strategy benchmark CSVs.

The port's copy of ``dvdx_tpu/utils/plots.py``: reads a runner CSV
(``parallel.runner.CSV_COLUMNS``, the JAX runner's schema) and writes the
same PNG files. ``pandas`` and ``matplotlib`` are imported inside the
functions, so the module imports on a host that has neither (the card's
machine); a plot asked for there raises ``ImportError`` naming the package.
"""

from __future__ import annotations

import os
from typing import List, Optional


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def load_results(csv_path: str):
    """The CSV as a pandas DataFrame."""
    import pandas as pd

    return pd.read_csv(csv_path)


def plot_metric_vs_world(df, metric: str, out_path: str,
                         emu: Optional[str] = None) -> str:
    plt = _plt()
    if emu:
        df = df[df["emu"] == emu]
    fig, ax = plt.subplots(figsize=(6.5, 4.5))
    for mode, g in df.groupby("mode"):
        g = g.sort_values("world_size")
        ax.plot(g["world_size"], g[metric], marker="o", label=mode)
    ax.set_xlabel("world size (devices)")
    ax.set_ylabel(metric)
    ax.set_title(f"{metric}" + (f" ({emu})" if emu else ""))
    ax.grid(alpha=0.3)
    ax.legend()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_all(csv_path: str, out_dir: str) -> List[str]:
    """The standard report: latency, fps, per-device params/memory, boundary
    instability, network bytes; one ``<metric>.png`` each in ``out_dir``."""
    df = load_results(csv_path)
    os.makedirs(out_dir, exist_ok=True)
    out = []
    for metric in ["latency_s", "throughput_fps", "param_mb_per_device",
                   "peak_mem_mb", "temp_instab", "flow_err", "network_bytes"]:
        if metric in df.columns:
            out.append(plot_metric_vs_world(df, metric,
                                            os.path.join(out_dir, f"{metric}.png")))
    return out


def plot_fsdp_vs_hybrid(csv_path: str, out_path: str) -> str:
    """Latency and per-device parameter footprint, fsdp against hybrid."""
    plt = _plt()
    df = load_results(csv_path)
    df = df[df["mode"].isin(["fsdp", "hybrid", "hybrid_ctx"])]
    fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
    for mode, g in df.groupby("mode"):
        g = g.sort_values("world_size")
        axes[0].plot(g["world_size"], g["latency_s"], marker="o", label=mode)
        axes[1].plot(g["world_size"], g["param_mb_per_device"], marker="o", label=mode)
    axes[0].set_xlabel("world size"); axes[0].set_ylabel("latency_s")
    axes[1].set_xlabel("world size"); axes[1].set_ylabel("param MB / device")
    for ax in axes:
        ax.grid(alpha=0.3)
        ax.legend()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path
