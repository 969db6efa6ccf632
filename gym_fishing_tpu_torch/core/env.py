"""The functional environment: plain `step` / `reset` over explicit records.

Counterpart of ``gym_fishing_tpu/core/env.py``:

    step(params, state, action, generator) -> (state', TimeStep)

- ``step_xi(params, state, action, xi, eta)`` — noise-injected, fully
  deterministic. The exactness tests drive this, the JAX engine and the NumPy
  oracle with the same N(0,1) stream.
- ``step(params, state, action, generator)`` — draws (xi, eta) from a
  `torch.Generator`.

Every function is elementwise over the leading dimensions of `state`, so the
same code steps one env (0-d tensors) or a batch (shape ``(num_envs,)``); the
batched engine with auto-reset lives in ``gym_fishing_tpu_torch.batch``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from gym_fishing_tpu_torch.core.types import EnvConfig, EnvParams, EnvState, TimeStep
from gym_fishing_tpu_torch.device import resolve
from gym_fishing_tpu_torch.dynamics.growth import get_growth_fn
from gym_fishing_tpu_torch.dynamics.noise import apply_process_noise
from gym_fishing_tpu_torch.spaces.scaling import (
    decode_action,
    encode_action,
    obs_from_stock,
    stock_from_obs,
)
from gym_fishing_tpu_torch.spaces.spaces import Box, Discrete


@dataclasses.dataclass(frozen=True)
class Env:
    """An assembled environment: static config + default params + functions."""

    id: str
    config: EnvConfig
    default_params: EnvParams

    # ------------------------------------------------------------------ spaces
    @property
    def action_space(self):
        if self.config.scheme == "continuous":
            return Box(-1.0, 1.0, (1,))
        return Discrete(self.config.n_actions)

    @property
    def observation_space(self):
        return Box(-1.0, 1.0, (1,))

    # ------------------------------------------------------------------- core
    def reset(
        self, params: EnvParams, generator: Optional[torch.Generator] = None
    ) -> EnvState:
        """Initial state. `generator` accepted for API symmetry (no reset
        noise — pinned, ORACLE_SEMANTICS.md). With per-instance params the
        fields, `t` included, take the params' shape."""
        del generator
        dtype, device = params.dtype, params.device
        stock = torch.as_tensor(params.init_state, dtype=dtype, device=device)
        return EnvState(
            stock=stock,
            harvest=torch.as_tensor(params.init_harvest, dtype=dtype, device=device),
            t=torch.zeros(stock.shape, dtype=torch.int32, device=device),
        )

    def step_xi(
        self,
        params: EnvParams,
        state: EnvState,
        action,
        xi,
        eta=None,
    ) -> Tuple[EnvState, TimeStep]:
        """Deterministic step given injected N(0,1) draws (xi, eta).

        Step order per ORACLE_SEMANTICS.md: decode -> harvest -> growth ->
        noise -> clip -> reward -> done -> observe.
        """
        cfg = self.config
        dtype = params.dtype
        x = state.stock
        zero = torch.zeros((), dtype=dtype, device=x.device)
        xi = torch.as_tensor(xi, dtype=dtype, device=x.device)
        eta = zero if eta is None else torch.as_tensor(eta, dtype=dtype, device=x.device)

        quota, new_h = decode_action(cfg, params, state.harvest, action)
        hv = torch.minimum(x, quota)
        x1 = x - hv
        # non-stationary drift: effective r at step t (identity when drift=0)
        p_g = params.replace(r=params.r + params.r_drift * state.t.to(dtype))
        mu = get_growth_fn(cfg.growth)(p_g, x1)
        x2 = apply_process_noise(cfg.noise_form, params, mu, x1, xi)
        x_next = torch.maximum(x2, zero)

        collapsed = x_next <= 0.0
        penalty = torch.as_tensor(params.collapse_penalty, dtype=dtype, device=x.device)
        reward = (
            params.price * hv
            - params.cost * quota * quota
            - torch.where(collapsed, penalty, zero)
        )
        t_next = state.t + 1
        done = (t_next >= params.Tmax) | collapsed

        if cfg.scheme != "relative":
            new_h = hv
        new_state = EnvState(stock=x_next, harvest=new_h, t=t_next)

        measured = x_next * torch.exp(params.sigma_m * eta)
        obs = obs_from_stock(params, measured)
        ts = TimeStep(
            obs=obs, reward=reward, done=done, quota=quota, harvest=hv,
            collapsed=collapsed,
        )
        return new_state, ts

    def step(
        self,
        params: EnvParams,
        state: EnvState,
        action,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[EnvState, TimeStep]:
        """Seeded step: one (xi, eta) pair per instance from `generator`."""
        x = state.stock
        xi = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
        eta = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
        return self.step_xi(params, state, action, xi, eta)

    # ------------------------------------------------------------- utilities
    def get_obs(self, params: EnvParams, state: EnvState):
        """Noise-free observation of the current state (reference `get_obs`)."""
        return obs_from_stock(params, state.stock)

    def get_fish_population(self, params: EnvParams, obs):
        return stock_from_obs(params, obs)

    def get_quota(self, params: EnvParams, state: EnvState, action):
        quota, _ = decode_action(self.config, params, state.harvest, action)
        return quota

    def get_action(self, params: EnvParams, state: EnvState, quota):
        """Inverse decode (reference `get_action`): desired quota -> action."""
        quota = torch.as_tensor(quota, dtype=params.dtype, device=state.stock.device)
        return encode_action(self.config, params, state.harvest, quota)

    def params(self, dtype=torch.float32, device=None, **overrides) -> EnvParams:
        """Default params cast to `dtype` on `device` (default: the card),
        with overrides applied."""
        p = self.default_params.replace(**overrides) if overrides else self.default_params
        return p.astype(dtype, resolve(device))


def make_env(
    env_id: str,
    growth: str = "logistic",
    noise_form: str = "additive",
    scheme: str = "continuous",
    n_actions: int = 3,
    **param_overrides,
) -> Env:
    """Assemble an Env from static choices + parameter overrides."""
    cfg = EnvConfig(
        growth=growth, noise_form=noise_form, scheme=scheme, n_actions=n_actions
    )
    params = EnvParams().replace(**param_overrides) if param_overrides else EnvParams()
    return Env(id=env_id, config=cfg, default_params=params)
