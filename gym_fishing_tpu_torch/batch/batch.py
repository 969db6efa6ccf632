"""Batched env engine: batched step, auto-reset, rollout loop.

Counterpart of ``gym_fishing_tpu/batch/batch.py``. A leading ``[num_envs]``
dimension on every state tensor steps all instances with one set of
elementwise ops (the env functions broadcast, so no ``vmap`` is needed).

RNG: one fused draw per step, a (2, num_envs) plane of N(0,1) — row 0 is
the process noise xi, row 1 the measurement noise eta. `batched_step` takes
either that plane itself (the exactness tests feed it the very draws the JAX
engine makes) or a `torch.Generator` to draw it from.

Auto-reset: when an instance reports done, its state is where-selected back
to the initial state in the same step, it observes the noise-free reset
obs, and the finished episode's return/length are reported in that step.

The env state may be any dataclass of tensors, as JAX's tree maps allow: an
`EnvState`, or a wrapper's record such as ``StackedState(env, window)``.
Params are shared by all instances (0-d fields) or per instance (fields
shaped ``[num_envs]``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple, Union

import torch

from gym_fishing_tpu_torch.core.env import Env
from gym_fishing_tpu_torch.core.tree import tree_leaves, tree_map
from gym_fishing_tpu_torch.core.types import EnvParams, TimeStep


@dataclasses.dataclass(frozen=True)
class BatchState:
    """Batched env state + per-instance episode accumulators."""

    env: Any                       # EnvState or a wrapper's state, leading [num_envs]
    episode_return: torch.Tensor   # running undiscounted return
    episode_length: torch.Tensor   # running episode length (int32)

    def replace(self, **kw) -> "BatchState":
        return dataclasses.replace(self, **kw)


def per_instance(params: EnvParams) -> bool:
    """Whether any field of `params` is per instance (not 0-d)."""
    return any(torch.as_tensor(x).dim() > 0 for x in tree_leaves(params))


def broadcast_params(params: EnvParams, num_envs: int) -> EnvParams:
    """`params` with every field shaped ``[num_envs]``."""
    return tree_map(lambda x: torch.as_tensor(x).expand(num_envs), params)


def where_done(done: torch.Tensor, init: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """`init` where `done`, else `new`; `done` [B] broadcast over trailing dims."""
    d = done.reshape(done.shape + (1,) * (new.dim() - done.dim()))
    return torch.where(d, init, new)


def batched_reset(
    env: Env, params: EnvParams, num_envs: int, device=None
) -> BatchState:
    """All-instances initial state on `device` (default: the params' device):
    the reset broadcast to a leading ``[num_envs]``, or, with per-instance
    params, each instance's own reset."""
    device = params.device if device is None else torch.device(device)
    if per_instance(params):
        state = env.reset(broadcast_params(params, num_envs))
        fill = lambda x: x.to(device).expand((num_envs,) + x.shape[1:])  # noqa: E731
    else:
        state = env.reset(params)
        fill = lambda x: x.to(device).expand((num_envs,) + x.shape)  # noqa: E731
    return BatchState(
        env=tree_map(lambda x: fill(x).clone(memory_format=torch.contiguous_format), state),
        episode_return=torch.zeros((num_envs,), dtype=params.dtype, device=device),
        episode_length=torch.zeros((num_envs,), dtype=torch.int32, device=device),
    )


def batched_step_xi(
    env: Env, params: EnvParams, state: Any, actions, xi, eta
) -> Tuple[Any, TimeStep]:
    """The injected-noise step over the instance dimension."""
    return env.step_xi(params, state, actions, xi, eta)


def batched_step(
    env: Env,
    params: EnvParams,
    state: BatchState,
    actions,
    noise: Union[torch.Tensor, torch.Generator, None] = None,
    autoreset: bool = True,
) -> Tuple[BatchState, "RolloutStep"]:
    """One batched step with optional auto-reset.

    `noise` is a (2, num_envs) tensor of N(0,1) draws (xi, eta), or a
    `torch.Generator` on the state's device to draw it from. When
    ``autoreset`` and an instance is done, its next state/obs are the
    post-reset ones while reward/done/episode stats describe the finished
    episode step.
    """
    num_envs = state.episode_return.shape[0]
    dtype = params.dtype
    device = state.episode_return.device
    if not isinstance(noise, torch.Tensor):
        noise = torch.randn((2, num_envs), generator=noise, dtype=dtype, device=device)
    if noise.shape != (2, num_envs):
        raise ValueError(f"noise must have shape (2, {num_envs}), got {tuple(noise.shape)}")
    env_state, ts = batched_step_xi(env, params, state.env, actions, noise[0], noise[1])

    ep_ret = state.episode_return + ts.reward
    ep_len = state.episode_length + 1

    if autoreset:
        reset_state = env.reset(params)
        done = ts.done
        env_state = tree_map(lambda new, init: where_done(done, init, new), env_state,
                             reset_state)
        # Done instances observe the (noise-free) reset state; everyone else
        # keeps the step's own obs so measurement noise (sigma_m) reaches the
        # policy.
        reset_obs = env.get_obs(params, reset_state)
        ts = ts.replace(obs=where_done(done, reset_obs, ts.obs))
        next_ret = torch.where(done, torch.zeros((), dtype=dtype, device=device), ep_ret)
        next_len = torch.where(done, torch.zeros_like(ep_len), ep_len)
    else:
        next_ret, next_len = ep_ret, ep_len

    new_state = BatchState(env=env_state, episode_return=next_ret, episode_length=next_len)
    # Surface the (completed-or-running) episode stats of *this* step.
    return new_state, _rollout_step(ts, ep_ret, ep_len)


@dataclasses.dataclass(frozen=True)
class RolloutStep:
    """One step of a rollout trajectory (or, from `rollout`, all steps
    stacked time-major)."""

    obs: Any
    action: Any
    reward: Any
    done: Any
    collapsed: Any  # done split: collapse (terminated) vs horizon (truncated)
    quota: Any
    harvest: Any
    episode_return: Any
    episode_length: Any

    def replace(self, **kw) -> "RolloutStep":
        return dataclasses.replace(self, **kw)


def _rollout_step(ts: TimeStep, ep_ret, ep_len) -> RolloutStep:
    return RolloutStep(
        obs=ts.obs,
        action=None,
        reward=ts.reward,
        done=ts.done,
        collapsed=ts.collapsed,
        quota=ts.quota,
        harvest=ts.harvest,
        episode_return=ep_ret,
        episode_length=ep_len,
    )


def rollout(
    env: Env,
    params: EnvParams,
    policy_fn: Callable[[torch.Tensor, Optional[torch.Generator]], Any],
    state: BatchState,
    generator: Optional[torch.Generator],
    num_steps: int,
    autoreset: bool = True,
) -> Tuple[BatchState, RolloutStep]:
    """Rollout loop of (policy -> batched step) over time.

    ``policy_fn(obs, generator) -> actions``. Returns the final state and a
    time-major trajectory whose tensors are shaped [num_steps, num_envs, ...].
    """
    obs = env.get_obs(params, state.env)
    steps = []
    for _ in range(num_steps):
        actions = policy_fn(obs, generator)
        state, ts = batched_step(env, params, state, actions, generator, autoreset)
        steps.append(ts.replace(action=actions))
        obs = ts.obs
    traj = RolloutStep(**{
        f.name: torch.stack([getattr(s, f.name) for s in steps])
        for f in dataclasses.fields(RolloutStep)
    })
    return state, traj
