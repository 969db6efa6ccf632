"""The constant-escapement baseline under structural and parameter
uncertainty: every env instance runs its own growth model and (r, K, sigma),
resampled per episode: the port of ``examples/model_uncertainty.py``.

    python -m gym_fishing_tpu_torch.examples.model_uncertainty [--num-envs 2048]
        [--horizon 128] [--steps 100] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from gym_fishing_tpu_torch.agents.policies import escapement
from gym_fishing_tpu_torch.batch.randomized import (
    make_param_sampler,
    randomized_reset,
    randomized_rollout,
)
from gym_fishing_tpu_torch.core.types import GROWTH_MODELS
from gym_fishing_tpu_torch.registry.registry import make

RANGES = {"model_idx": (0, len(GROWTH_MODELS) - 1), "r": (0.2, 1.0), "K": (0.7, 1.3),
          "sigma": (0.0, 0.1)}


def uncertainty_rollout(num_envs: int, horizon: int, steps: int, device=None, seed: int = 0):
    """`steps` chained randomized rollouts of `horizon` steps of escapement on
    fishing-mixture-v1 under `RANGES`, on `device` (default: the card).
    Returns (env-steps, mean reward per step, {growth model: instances at
    the end})."""
    env, params = make("fishing-mixture-v1", device=device)
    sampler = make_param_sampler(params, RANGES)
    gen = torch.Generator(device=params.device).manual_seed(seed)
    state, bparams = randomized_reset(env, sampler, num_envs, gen)
    pol = escapement(env, params)
    total = torch.zeros((), dtype=torch.float64, device=params.device)
    for _ in range(steps):
        state, bparams, traj = randomized_rollout(env, sampler, lambda obs, g: pol.act(obs),
                                                  state, bparams, gen, horizon)
        total = total + traj.reward.double().sum()
    n = num_envs * horizon * steps
    counts = torch.bincount(bparams.model_idx.long(), minlength=len(GROWTH_MODELS))
    return n, float(total) / n, dict(zip(GROWTH_MODELS, counts.tolist()))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num-envs", type=int, default=2048)
    ap.add_argument("--horizon", type=int, default=128)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    n, mean_r, models = uncertainty_rollout(args.num_envs, args.horizon, args.steps, args.device)
    print(f"steps: {n:,}  mean reward/step: {mean_r:.4f}")
    print("active growth models:", models)


if __name__ == "__main__":
    main()
