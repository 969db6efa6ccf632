"""Functional environment wrappers.

Counterpart of ``gym_fishing_tpu/envs/wrappers.py``. ``ObsStackEnv`` stacks
the last k (possibly noise-corrupted) observations into one window so that
memoryless policies can act on the partially observed variants: the
observation-noise envs (``sigma_m > 0``), the growth-model mixture and the
non-stationary drift env. The wrapper speaks the same protocol as
``core.env.Env`` (`reset` / `step` / `step_xi` / `get_obs`), so the batched
engine, its auto-reset and the learners take it unchanged.

State is ``StackedState(env, window)``: the window is a tensor like any other
field, ``[..., k]`` with the newest observation last, and the batched engine
carries it with a leading ``[num_envs]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from gym_fishing_tpu_torch.core.env import Env
from gym_fishing_tpu_torch.core.types import EnvParams, TimeStep
from gym_fishing_tpu_torch.spaces.spaces import Box


@dataclasses.dataclass(frozen=True)
class StackedState:
    """Inner env state + rolling observation window (most recent last)."""

    env: Any               # inner EnvState
    window: torch.Tensor   # (..., k) observations

    def replace(self, **kw) -> "StackedState":
        return dataclasses.replace(self, **kw)

    # the inner fields the learners read (e.g. the carried harvest)
    @property
    def harvest(self):
        return self.env.harvest

    @property
    def stock(self):
        return self.env.stock

    @property
    def t(self):
        return self.env.t


@dataclasses.dataclass(frozen=True)
class ObsStackEnv:
    """k-step observation window over an inner functional env."""

    inner: Env
    k: int = 4

    def __post_init__(self) -> None:
        if self.k < 1:
            raise ValueError("k must be >= 1")
        if self.inner.observation_space.shape != (1,):
            raise ValueError("ObsStackEnv expects a scalar-observation inner env")

    # ----------------------------------------------------------------- labels
    @property
    def id(self) -> str:
        return f"{self.inner.id}-stack{self.k}"

    @property
    def config(self):
        return self.inner.config

    @property
    def default_params(self) -> EnvParams:
        return self.inner.default_params

    def params(self, *args, **kwargs) -> EnvParams:
        return self.inner.params(*args, **kwargs)

    # ----------------------------------------------------------------- spaces
    @property
    def action_space(self):
        return self.inner.action_space

    @property
    def observation_space(self):
        return Box(-1.0, 1.0, (self.k,))

    # ------------------------------------------------------------------- core
    def reset(self, params: EnvParams,
              generator: Optional[torch.Generator] = None) -> StackedState:
        """The inner reset, its observation copied into every window slot."""
        s = self.inner.reset(params, generator)
        obs0 = self.inner.get_obs(params, s)
        return StackedState(env=s, window=obs0.expand(obs0.shape[:-1] + (self.k,)).clone())

    @staticmethod
    def _push(window: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        return torch.cat([window[..., 1:], obs], dim=-1)

    def step_xi(self, params, state: StackedState, action, xi, eta=None
                ) -> Tuple[StackedState, TimeStep]:
        s, ts = self.inner.step_xi(params, state.env, action, xi, eta)
        window = self._push(state.window, ts.obs)
        return StackedState(env=s, window=window), ts.replace(obs=window)

    def step(self, params, state: StackedState, action,
             generator: Optional[torch.Generator] = None) -> Tuple[StackedState, TimeStep]:
        s, ts = self.inner.step(params, state.env, action, generator)
        window = self._push(state.window, ts.obs)
        return StackedState(env=s, window=window), ts.replace(obs=window)

    # ------------------------------------------------------------- utilities
    def get_obs(self, params: EnvParams, state: StackedState):
        return state.window

    def get_fish_population(self, params: EnvParams, obs):
        # the latest window entry is the current (measured) observation
        return self.inner.get_fish_population(params, obs[..., -1:])

    def get_quota(self, params: EnvParams, state: StackedState, action):
        return self.inner.get_quota(params, state.env, action)

    def get_action(self, params: EnvParams, state: StackedState, quota):
        return self.inner.get_action(params, state.env, quota)


def stack_observations(env: Env, k: int = 4) -> ObsStackEnv:
    """Wrap `env` with a k-step observation window (POMDP remedy)."""
    return ObsStackEnv(inner=env, k=k)
