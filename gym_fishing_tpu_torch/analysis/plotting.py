"""Matplotlib plots + CSV export (reference parity).

Counterpart of ``gym_fishing_tpu/analysis/plotting.py``, which imports no
JAX but lives in a package whose ``__init__`` does, so the port keeps this
copy. Reference: gym_fishing's ``plot_mdp(df, output)`` and
``plot_policyfn(df, output)``: stacked state/action/reward panels over time
per rep, and the policy function over the state grid. Saves to PNG when
`output` is given; returns the figure.
"""

from __future__ import annotations

from typing import Optional

import matplotlib

matplotlib.use("Agg")  # headless
import matplotlib.pyplot as plt  # noqa: E402
import pandas as pd  # noqa: E402


def plot_mdp(df: pd.DataFrame, output: Optional[str] = None):
    """Three stacked panels (state, action, reward vs time), one line per rep."""
    fig, axes = plt.subplots(3, 1, sharex=True, figsize=(7, 7))
    for rep, sub in df.groupby("rep"):
        axes[0].plot(sub["time"], sub["state"], alpha=0.6, lw=1)
        axes[1].plot(sub["time"], sub["action"], alpha=0.6, lw=1)
        axes[2].plot(sub["time"], sub["reward"], alpha=0.6, lw=1)
    axes[0].set_ylabel("state")
    axes[1].set_ylabel("action")
    axes[2].set_ylabel("reward")
    axes[2].set_xlabel("time")
    fig.tight_layout()
    if output:
        fig.savefig(output, dpi=120)
        plt.close(fig)
    return fig


def plot_policyfn(df: pd.DataFrame, output: Optional[str] = None):
    """Action as a function of state (policy function), one line per rep."""
    fig, ax = plt.subplots(figsize=(6, 4))
    for rep, sub in df.groupby("rep"):
        ax.plot(sub["state"], sub["action"], alpha=0.7, lw=1.2)
    ax.set_xlabel("state (stock)")
    ax.set_ylabel("action")
    fig.tight_layout()
    if output:
        fig.savefig(output, dpi=120)
        plt.close(fig)
    return fig


def write_csv(df: pd.DataFrame, path: str) -> None:
    """CSV export (reference `file=` episode logging parity)."""
    df.to_csv(path, index=False)
