"""Solve the fishing MDP by dynamic programming and compare the optimal
policy with the closed-form baselines: the port of
``examples/dp_optimal.py``.

    python -m gym_fishing_tpu_torch.examples.dp_optimal --env fishing-v1 --sigma 0.05
        --gamma 0.995 [--n-states 257] [--n-quotas 129] [--reps 16] [--out plot.png]
        [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gym_fishing_tpu_torch.agents.dp import _interp, dp, policy_evaluation
from gym_fishing_tpu_torch.agents.policies import escapement, msy
from gym_fishing_tpu_torch.analysis.simulate import _simulate_steps
from gym_fishing_tpu_torch.examples import can_write_artifacts
from gym_fishing_tpu_torch.registry.registry import make


def dp_report(env_id: str = "fishing-v1", sigma: float = 0.05, gamma: float = 0.995,
              n_states: int = 257, n_quotas: int = 129, reps: int = 16, device=None,
              seed: int = 0):
    """Value iteration on the discretized env, then for the DP policy, msy
    and escapement: the mean and sd over `reps` simulated episodes' returns
    (`simulate_mdp`'s device path) and the exact discounted value at the
    initial stock (`policy_evaluation`). Returns (solution, params, {name:
    (mean return, sd, V^pi(x0))})."""
    env, params = make(env_id, sigma=sigma, device=device)
    pol_dp = dp(env, params, gamma=gamma, n_states=n_states, n_quotas=n_quotas)
    x0 = torch.as_tensor(params.init_state)
    Tmax = int(torch.as_tensor(params.Tmax))
    rows, mdp = {}, None
    for name, pol in (("dp", pol_dp), ("msy", msy(env, params)),
                      ("escapement", escapement(env, params))):
        gen = torch.Generator(device=params.device).manual_seed(seed)
        _, _, rewards = _simulate_steps(env, pol, reps, params, Tmax, gen)
        ret = rewards.double().sum(0)
        V_pi, mdp = policy_evaluation(env, pol.quota, params, gamma=gamma, n_states=n_states,
                                      n_quotas=n_quotas, mdp=mdp)
        rows[name] = (float(ret.mean()), float(ret.std()), float(_interp(x0, mdp.grid, V_pi)))
    return pol_dp.solution, params, rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--env", default="fishing-v1")
    ap.add_argument("--sigma", type=float, default=0.05)
    ap.add_argument("--gamma", type=float, default=0.995)
    ap.add_argument("--n-states", type=int, default=257)
    ap.add_argument("--n-quotas", type=int, default=129)
    ap.add_argument("--reps", type=int, default=16)
    ap.add_argument("--out", default=None, help="write policy-function plot here")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    sol, params, rows = dp_report(args.env, args.sigma, args.gamma, args.n_states,
                                  args.n_quotas, args.reps, args.device)
    x0 = float(torch.as_tensor(params.init_state))
    print(f"value iteration: {sol.iterations} sweeps, residual {float(sol.residual):.2e}")
    print(f"V(init={x0:.2f}) = {float(_interp(torch.tensor(x0), sol.grid, sol.V)):.3f}")
    for name, (mean, sd, v0) in rows.items():
        print(f"{name:12s} mean return {mean:8.3f}  (sd {sd:.3f})"
              f"   exact discounted value V^pi({x0:.2f}) = {v0:.3f}")

    if args.out:
        if not can_write_artifacts():
            print("pandas or matplotlib is not installed: no plot is written")
            return
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        grid = sol.grid.cpu().numpy()
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(grid, sol.policy_quota.cpu().numpy(), label="DP optimal quota")
        ax.plot(grid, np.maximum(grid - 0.5, 0.0), "--", label="escapement K/2")
        ax.set_xlabel("stock")
        ax.set_ylabel("quota")
        ax.legend()
        fig.savefig(args.out, dpi=120, bbox_inches="tight")
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
