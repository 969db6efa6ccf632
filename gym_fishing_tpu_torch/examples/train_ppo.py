"""Train PPO (or A2C) through the sb3-style facade and compare the trained
return with the closed-form baselines: the port of ``examples/train_ppo.py``.

    python -m gym_fishing_tpu_torch.examples.train_ppo [--env fishing-v1]
        [--timesteps 2000000] [--algo ppo|a2c] [--fused off|update|full]
        [--fused-adam] [--device cpu]

Writes <out>/ckpt (the facade's checkpoint) and, where pandas and
matplotlib are installed, <out>/{sim.csv, mdp.png, policy.png}; prints the
trained mean episode return beside MSY's and constant escapement's.
``--fused full --fused-adam`` runs each PPO iteration as one launch of the
policy-rollout kernel and epochs x minibatches launches of the fused
gradient + Adam kernel.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import torch

from gym_fishing_tpu_torch.agents.policies import escapement, msy
from gym_fishing_tpu_torch.agents.sb3_like import A2C, PPO
from gym_fishing_tpu_torch.analysis.simulate import _simulate_steps
from gym_fishing_tpu_torch.examples import can_write_artifacts
from gym_fishing_tpu_torch.registry.registry import make

REPS = 10


def mean_returns(env, params, policies: Dict[str, object], reps: int = REPS,
                 seed: int = 0) -> Dict[str, float]:
    """Mean episode return of each policy over `reps` episodes of
    `simulate_mdp`'s device path."""
    out = {}
    for name, pol in policies.items():
        gen = torch.Generator(device=params.device).manual_seed(seed)
        _, _, rewards = _simulate_steps(env, pol, reps, params, int(params.Tmax), gen)
        out[name] = float(rewards.double().sum(0).mean())
    return out


def train_model(env_id: str = "fishing-v1", algo: str = "ppo", timesteps: int = 2_000_000,
                num_envs: int = 4096, num_steps: int = 128, sigma: float = 0.05,
                seed: int = 0, fused: str = "off", fused_adam: bool = False,
                shuffle: str = "exact", verbose: int = 1, device=None):
    """The facade after `learn(timesteps)` on `device` (default: the card),
    with the env and its params."""
    env, params = make(env_id, sigma=sigma, device=device)
    extra = ({"fused_update": fused in ("update", "full"), "fused_rollout": fused == "full",
              "fused_adam": fused_adam, "shuffle": shuffle} if algo == "ppo" else {})
    cls = {"ppo": PPO, "a2c": A2C}[algo]
    model = cls("MlpPolicy", (env, params), num_envs=num_envs, num_steps=num_steps, seed=seed,
                verbose=verbose, device=device, **extra)
    model.learn(total_timesteps=timesteps)
    return model, env, params


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--env", default="fishing-v1")
    ap.add_argument("--algo", choices=["ppo", "a2c"], default="ppo")
    ap.add_argument("--timesteps", type=int, default=2_000_000)
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--num-steps", type=int, default=128)
    ap.add_argument("--sigma", type=float, default=0.05)
    ap.add_argument("--out", default="ppo_fishing")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fused", nargs="?", const="update", default="off",
                    choices=["off", "update", "full"],
                    help="PPO only: 'update' runs every minibatch gradient through the fused "
                    "update kernel; 'full' also runs rollout + GAE in the policy-rollout "
                    "kernel (scalar observations)")
    ap.add_argument("--shuffle", choices=["exact", "affine"], default="exact",
                    help="PPO only: the epoch shuffle ('affine' is not ported and raises)")
    ap.add_argument("--fused-adam", action="store_true",
                    help="PPO only (with --fused): clip-by-global-norm + Adam inside the "
                    "update kernel, one launch per minibatch")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    model, env, params = train_model(args.env, args.algo, args.timesteps, args.num_envs,
                                     args.num_steps, args.sigma, args.seed, args.fused,
                                     args.fused_adam, args.shuffle, device=args.device)
    os.makedirs(args.out, exist_ok=True)
    model.save(os.path.join(args.out, "ckpt"))
    rets = mean_returns(env, params, {args.algo: model.policy, "msy": msy(env, params),
                                      "escapement": escapement(env, params)})
    if can_write_artifacts():
        from gym_fishing_tpu_torch.analysis import estimate_policyfn, simulate_mdp
        from gym_fishing_tpu_torch.analysis.plotting import plot_mdp, plot_policyfn, write_csv

        df = simulate_mdp(env, model.policy, reps=REPS, params=params)
        write_csv(df, os.path.join(args.out, "sim.csv"))
        plot_mdp(df, os.path.join(args.out, "mdp.png"))
        dfp = estimate_policyfn(env, model.policy, reps=1, n=100, params=params)
        plot_policyfn(dfp, os.path.join(args.out, "policy.png"))
    else:
        print("pandas or matplotlib is not installed: no CSV or plot is written")
    print(f"mean episode return: {args.algo}={rets[args.algo]:.3f}  msy={rets['msy']:.3f}  "
          f"escapement={rets['escapement']:.3f}")


if __name__ == "__main__":
    main()
