"""Roll the closed-form policies (msy, escapement) on every registered env
and write tidy CSVs and plots: the port of ``examples/simulate_baselines.py``.

    python -m gym_fishing_tpu_torch.examples.simulate_baselines --out results/ [--reps 10]
                                                               [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import torch

from gym_fishing_tpu_torch.agents.policies import escapement, msy
from gym_fishing_tpu_torch.analysis.simulate import _simulate_steps
from gym_fishing_tpu_torch.examples import can_write_artifacts
from gym_fishing_tpu_torch.registry.registry import make, registered_ids

POLICIES = (("msy", msy), ("escapement", escapement))


def baseline_trajectories(reps: int, device=None, seed: int = 0):
    """Yield (env_id, policy name, env, params, (obs, actions, rewards)) for
    every registered env and baseline: `simulate_mdp`'s device path, `reps`
    episodes of Tmax steps as one batch, the tensors [Tmax, reps, ...] on
    `device` (default: the card)."""
    for env_id in registered_ids():
        env, params = make(env_id, device=device)
        for name, cls in POLICIES:
            gen = torch.Generator(device=params.device).manual_seed(seed)
            traj = _simulate_steps(env, cls(env, params), reps, params,
                                   int(torch.as_tensor(params.Tmax)), gen)
            yield env_id, name, env, params, traj


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="results")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    write = can_write_artifacts()
    if write:
        import matplotlib.pyplot as plt

        from gym_fishing_tpu_torch.analysis.plotting import plot_mdp, write_csv
        from gym_fishing_tpu_torch.analysis.simulate import _traj_to_df
    else:
        print("pandas or matplotlib is not installed: no CSV or plot is written")
    os.makedirs(args.out, exist_ok=True)
    for env_id, name, env, params, traj in baseline_trajectories(args.reps, args.device):
        if write:
            df = _traj_to_df(env, params, *traj, int(torch.as_tensor(params.Tmax)), args.reps)
            base = os.path.join(args.out, f"{env_id}_{name}")
            write_csv(df, base + ".csv")
            plt.close(plot_mdp(df, base + ".png"))
        ret = float(traj[2].sum(0).double().mean())
        print(f"{env_id:28s} {name:10s} mean return {ret:8.3f}")


if __name__ == "__main__":
    main()
