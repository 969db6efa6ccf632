"""May (1977) tipping point: sweep the initial stock across the unstable
equilibrium of the bistable May env under zero harvest and plot the basins
of attraction: the port of ``examples/tipping_point.py``.

    python -m gym_fishing_tpu_torch.examples.tipping_point --out may_basins.png
                                                          [--horizon 300] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from gym_fishing_tpu_torch.batch import batched_reset, rollout
from gym_fishing_tpu_torch.examples import can_write_artifacts
from gym_fishing_tpu_torch.registry.registry import make

UNSTABLE = 0.30   # the unstable equilibrium of fishing-may-v1's defaults


def basin_stocks(x0: torch.Tensor, horizon: int, device=None) -> torch.Tensor:
    """Stocks [horizon, B] of fishing-may-v1 (no noise, no harvest) from the
    initial stocks `x0` [B], through the batch engine's `rollout` without
    auto-reset, on `device` (default: the card)."""
    env, params = make("fishing-may-v1", sigma=0.0, Tmax=10_000, device=device)
    B = x0.shape[0]
    state = batched_reset(env, params, B)
    state = dataclasses.replace(state, env=dataclasses.replace(
        state.env, stock=x0.to(dtype=params.dtype, device=params.device)))
    zero_quota = torch.full((B, 1), -1.0, dtype=params.dtype, device=params.device)
    gen = torch.Generator(device=params.device).manual_seed(0)
    _, traj = rollout(env, params, lambda obs, g: zero_quota, state, gen, horizon,
                      autoreset=False)
    return (traj.obs[..., 0] + 1.0) * params.K   # K = 1: obs -> stock


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="may_basins.png")
    ap.add_argument("--horizon", type=int, default=300)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    x0 = torch.linspace(0.01, 1.0, 64, dtype=torch.float64).to(torch.float32)
    stocks = basin_stocks(x0, args.horizon, args.device).cpu()
    recover = stocks[-1] > UNSTABLE
    print(f"{int(recover.sum())} of {len(x0)} initial stocks recover, "
          f"{int((~recover).sum())} collapse")
    if not can_write_artifacts():
        print("pandas or matplotlib is not installed: no plot is written")
        return
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4.5))
    for i in range(stocks.shape[1]):
        ax.plot(stocks[:, i].numpy(), lw=0.8, alpha=0.7,
                color="tab:blue" if bool(recover[i]) else "tab:red")
    ax.axhline(UNSTABLE, ls="--", c="k", lw=1, label="unstable equilibrium ~0.30")
    ax.set_xlabel("year")
    ax.set_ylabel("stock")
    ax.set_title("May model basins of attraction (blue: recover, red: collapse)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(args.out, dpi=130)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
