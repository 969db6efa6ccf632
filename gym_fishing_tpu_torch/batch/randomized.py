"""Per-instance / per-episode parameter randomization (model uncertainty).

Counterpart of ``gym_fishing_tpu/batch/randomized.py``. A batched params
record (every field shaped ``[num_envs]``) steps through the env functions
like the state does, so every instance can run its own (r, K, sigma, growth
model, ...), and an instance whose episode ends gets fresh params and a
fresh state in the same step: domain randomization for robust policies.

Randomness: the sampler draws from a `torch.Generator`: U(lo, hi) for float
fields, U{lo..hi} for the integer fields ``model_idx`` and ``Tmax``, one
draw per instance and ranged field, fields in sorted order. A step's noise is
a ``(2, num_envs)`` tensor of N(0,1) draws or a generator to draw it from,
as in `batched_step`; the resampling draws come after it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from gym_fishing_tpu_torch.batch.batch import (
    BatchState,
    RolloutStep,
    broadcast_params,
    where_done,
)
from gym_fishing_tpu_torch.core.env import Env
from gym_fishing_tpu_torch.core.tree import tree_map
from gym_fishing_tpu_torch.core.types import EnvParams

_INT_FIELDS = ("model_idx", "Tmax")


def make_param_sampler(
    base: EnvParams, ranges: Dict[str, Tuple[float, float]]
) -> Callable[[Optional[torch.Generator], int], EnvParams]:
    """sample(generator, num_envs) -> EnvParams with every field shaped
    ``[num_envs]``, the `ranges` fields drawn per instance ~ U(lo, hi)
    (U{lo..hi} for the integer fields) on `base`'s device, the others
    `base`'s."""
    names = sorted(ranges)
    unknown = [n for n in names if n not in {f.name for f in dataclasses.fields(EnvParams)}]
    if unknown:
        raise TypeError(f"unknown EnvParams field(s) {unknown}")

    def sample(generator: Optional[torch.Generator], num_envs: int) -> EnvParams:
        device = base.device
        draws = {}
        for name in names:
            lo, hi = ranges[name]
            if name in _INT_FIELDS:
                draws[name] = torch.randint(int(lo), int(hi) + 1, (num_envs,),
                                            generator=generator, dtype=torch.int32,
                                            device=device)
            else:
                u = torch.rand((num_envs,), generator=generator, dtype=base.dtype,
                               device=device)
                draws[name] = lo + (hi - lo) * u
        return broadcast_params(base.replace(**draws), num_envs)

    return sample


def randomized_reset(
    env: Env,
    sample_fn: Callable[[Optional[torch.Generator], int], EnvParams],
    num_envs: int,
    generator: Optional[torch.Generator] = None,
) -> Tuple[BatchState, EnvParams]:
    """Batched initial state + per-instance sampled params (fields [B])."""
    bparams = sample_fn(generator, num_envs)
    env_state = tree_map(lambda x: x.clone(memory_format=torch.contiguous_format),
                         env.reset(bparams))
    device = bparams.device
    state = BatchState(
        env=env_state,
        episode_return=torch.zeros((num_envs,), dtype=bparams.dtype, device=device),
        episode_length=torch.zeros((num_envs,), dtype=torch.int32, device=device),
    )
    return state, bparams


def randomized_step(
    env: Env,
    sample_fn: Callable[[Optional[torch.Generator], int], EnvParams],
    bparams: EnvParams,
    state: BatchState,
    actions,
    noise: Union[torch.Tensor, torch.Generator, None] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[BatchState, EnvParams, RolloutStep]:
    """One step with per-instance params; done instances get fresh params.

    Mirrors `batched_step(autoreset=True)` with the params carried beside
    the state and resampled at episode boundaries. `noise` is the step's
    (2, B) draws or a generator; the fresh params come from `generator`
    (default: `noise` when it is a generator). Every instance observes its
    state's noise-free observation, as in the JAX function.
    """
    num_envs = state.episode_return.shape[0]
    device = state.episode_return.device
    if not isinstance(noise, torch.Tensor):
        generator = noise if generator is None else generator
        noise = torch.randn((2, num_envs), generator=noise, dtype=bparams.dtype, device=device)
    if noise.shape != (2, num_envs):
        raise ValueError(f"noise must have shape (2, {num_envs}), got {tuple(noise.shape)}")
    env_state, ts = env.step_xi(bparams, state.env, actions, noise[0], noise[1])

    ep_ret = state.episode_return + ts.reward
    ep_len = state.episode_length + 1
    done = ts.done

    fresh_params = sample_fn(generator, num_envs)
    fresh_state = env.reset(fresh_params)

    def sel(new, init):
        return where_done(done, init, new)

    env_state = tree_map(sel, env_state, fresh_state)
    bparams = tree_map(sel, bparams, fresh_params)
    obs = env.get_obs(bparams, env_state)
    new_state = BatchState(
        env=env_state,
        episode_return=torch.where(done, torch.zeros_like(ep_ret), ep_ret),
        episode_length=torch.where(done, torch.zeros_like(ep_len), ep_len),
    )
    out = RolloutStep(
        obs=obs, action=None, reward=ts.reward, done=done,
        collapsed=ts.collapsed, quota=ts.quota, harvest=ts.harvest,
        episode_return=ep_ret, episode_length=ep_len,
    )
    return new_state, bparams, out


def randomized_rollout(
    env: Env,
    sample_fn: Callable[[Optional[torch.Generator], int], EnvParams],
    policy_fn: Callable,
    state: BatchState,
    bparams: EnvParams,
    generator: Optional[torch.Generator],
    num_steps: int,
) -> Tuple[BatchState, EnvParams, RolloutStep]:
    """`num_steps` steps of ``policy_fn(obs, generator) -> actions`` and
    `randomized_step`, with per-episode parameter resampling. Returns the
    final state and params and a time-major trajectory [num_steps, B, ...]."""
    obs = env.get_obs(bparams, state.env)
    steps = []
    for _ in range(num_steps):
        actions = policy_fn(obs, generator)
        state, bparams, out = randomized_step(env, sample_fn, bparams, state, actions,
                                              generator)
        steps.append(dataclasses.replace(out, action=actions))
        obs = out.obs
    traj = RolloutStep(**{
        f.name: torch.stack([getattr(s, f.name) for s in steps])
        for f in dataclasses.fields(RolloutStep)
    })
    return state, bparams, traj
