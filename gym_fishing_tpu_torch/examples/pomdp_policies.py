"""Compare the three POMDP remedies on an observation-noise env: memoryless
PPO on the raw noisy observation, PPO on a k-step observation window
(envs.ObsStackEnv), and recurrent PPO (a GRU belief state,
agents.ppo_rnn), beside constant escapement on the noisy observation: the
port of ``examples/pomdp_policies.py``.

    python -m gym_fishing_tpu_torch.examples.pomdp_policies [--sigma-m 0.15]
        [--iterations 100] [--num-envs 256] [--reps 16] [--k 6] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, Tuple

import torch

from gym_fishing_tpu_torch.agents.policies import escapement
from gym_fishing_tpu_torch.agents.ppo import PPOConfig, PPOPolicy, train
from gym_fishing_tpu_torch.agents.ppo_rnn import RecurrentPPOPolicy, RPPOConfig
from gym_fishing_tpu_torch.agents.ppo_rnn import train as rppo_train
from gym_fishing_tpu_torch.analysis.simulate import _simulate_host_steps, _simulate_steps
from gym_fishing_tpu_torch.envs.wrappers import stack_observations
from gym_fishing_tpu_torch.registry.registry import make


def pomdp_returns(env_id: str = "fishing-v1", sigma: float = 0.02, sigma_m: float = 0.15,
                  k: int = 6, iterations: int = 100, num_envs: int = 256, reps: int = 16,
                  device=None, seed: int = 0) -> Dict[str, Tuple[float, float]]:
    """Train the three learners for `iterations` each on `device` (default:
    the card) and roll `reps` episodes of each policy: {name: (mean return,
    its sample standard deviation)}. The policies with `.act` take
    `simulate_mdp`'s device path, the recurrent one its `.predict` loop."""
    env, params = make(env_id, sigma=sigma, sigma_m=sigma_m, device=device)
    wenv = stack_observations(env, k=k)
    cfg = PPOConfig(num_envs=num_envs, num_steps=32, epochs=2, num_minibatches=4)
    # a small entropy bonus keeps the GRU policy exploring long enough to
    # find the sustainable-harvest regime
    rcfg = RPPOConfig(num_envs=num_envs, num_steps=32, epochs=2, num_minibatches=4, hidden=32,
                      ent_coef=0.003)
    ts_raw, _ = train(env, cfg, seed=seed, iterations=iterations, env_params=params,
                      device=device)
    ts_stk, _ = train(wenv, cfg, seed=seed, iterations=iterations, env_params=params,
                      device=device)
    ts_rnn, _ = rppo_train(env, rcfg, iterations=iterations, seed=seed, env_params=params,
                           device=device)
    rows = [
        ("PPO raw obs", env, PPOPolicy(env, ts_raw)),
        (f"PPO {k}-step window", wenv, PPOPolicy(wenv, ts_stk)),
        ("recurrent PPO (GRU)", env, RecurrentPPOPolicy(env, ts_rnn, rcfg)),
        ("escapement (sees noisy obs)", env, escapement(env, params)),
    ]
    Tmax = int(params.Tmax)
    out = {}
    for name, e, pol in rows:
        gen = torch.Generator(device=params.device).manual_seed(seed)
        steps = _simulate_steps if hasattr(pol, "act") else _simulate_host_steps
        _, _, rewards = steps(e, pol, reps, params, Tmax, gen)
        ret = rewards.double().sum(0)
        out[name] = (float(ret.mean()), float(ret.std()))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--env", default="fishing-v1")
    ap.add_argument("--sigma", type=float, default=0.02)
    ap.add_argument("--sigma-m", type=float, default=0.15)
    ap.add_argument("--k", type=int, default=6, help="observation-window length")
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--num-envs", type=int, default=256)
    ap.add_argument("--reps", type=int, default=16)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    rows = pomdp_returns(args.env, args.sigma, args.sigma_m, args.k, args.iterations,
                         args.num_envs, args.reps, args.device)
    for name, (mean, sd) in rows.items():
        print(f"{name:30s} mean return {mean:7.3f}  (sd {sd:.3f})")


if __name__ == "__main__":
    main()
