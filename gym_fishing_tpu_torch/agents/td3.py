"""TD3 (twin delayed DDPG), the third continuous-control member of the sb3
family the reference's experiments train.

Counterpart of ``gym_fishing_tpu/agents/td3.py``. It shares SAC's replay
buffer, `DoubleCritic` and `AdamState` (``agents/sac.py``). One
`td3_train_step` is one batched env step with clipped Gaussian exploration
and ``updates_per_step`` updates with clipped target-policy smoothing. The
actor's loss is computed on every update (for the metric); its gradient, its
step (its Adam count and moments with it) and the soft updates of both
targets happen only on every ``policy_delay``-th update, ``update_count %
policy_delay == policy_delay - 1``. The count is a host int, so the delay is
a host branch.

Injectable draws: ``act_noise [B, A]`` (exploration normals, before the
``explore_noise`` scale), ``env_noise [2, B]``, and per update
``sample_idx [U, batch]`` and ``smooth_noise [U, batch, A]`` (smoothing
normals, before the ``target_noise`` scale).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from gym_fishing_tpu_torch.agents.es import _lecun_linear
from gym_fishing_tpu_torch.agents.ppo import OPTAX_ADAM_EPS, adam_apply
from gym_fishing_tpu_torch.agents.sac import (
    AdamState,
    DoubleCritic,
    ReplayBuffer,
    _draw,
    _require_continuous,
    adam_init,
    buffer_add,
    buffer_init,
    buffer_sample,
    grads_of,
    soft_update,
    step_episode_return,
    true_done,
)
from gym_fishing_tpu_torch.batch import BatchState, batched_reset, batched_step
from gym_fishing_tpu_torch.core.env import Env
from gym_fishing_tpu_torch.core.types import EnvParams
from gym_fishing_tpu_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class TD3Config:
    num_envs: int = 256
    buffer_size: int = 1 << 17
    batch_size: int = 4096
    gamma: float = 0.99
    tau: float = 0.005
    lr: float = 3e-4
    hidden: int = 64
    updates_per_step: int = 1
    explore_noise: float = 0.1       # behavior-policy Gaussian noise
    target_noise: float = 0.2        # target-policy smoothing
    target_noise_clip: float = 0.5
    policy_delay: int = 2


class DeterministicActor(nn.Module):
    """Two tanh layers (``d1``, ``d2``) and a tanh-squashed ``out``."""

    def __init__(self, obs_dim: int, act_dim: int, hidden: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d1 = _lecun_linear(obs_dim, hidden, generator)
        self.d2 = _lecun_linear(hidden, hidden, generator)
        self.out = _lecun_linear(hidden, act_dim, generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.out(torch.tanh(self.d2(torch.tanh(self.d1(obs))))))


@dataclasses.dataclass
class TD3State:
    actor: DeterministicActor
    critic: DoubleCritic
    target_actor: DeterministicActor
    target_critic: DoubleCritic
    actor_opt: AdamState
    critic_opt: AdamState
    buffer: ReplayBuffer
    env_state: BatchState
    obs: torch.Tensor
    update_count: int = 0  # for the delayed policy update


def make_td3_state(env: Env, cfg: TD3Config, generator: Optional[torch.Generator] = None,
                   env_params: Optional[EnvParams] = None, device=None) -> TD3State:
    """Fresh networks (initialised from the CPU `generator`), an empty
    buffer and the reset envs on `device` (default: the card)."""
    _require_continuous(env, "TD3")
    device = resolve(device)
    if env_params is None:
        env_params = env.params(device=device)
    obs_dim, act_dim = env.observation_space.shape[0], 1
    actor = DeterministicActor(obs_dim, act_dim, cfg.hidden, generator).to(device)
    critic = DoubleCritic(obs_dim, act_dim, cfg.hidden, generator).to(device)
    bstate = batched_reset(env, env_params, cfg.num_envs, device)
    return TD3State(
        actor=actor, critic=critic,
        target_actor=copy.deepcopy(actor), target_critic=copy.deepcopy(critic),
        actor_opt=adam_init(dict(actor.named_parameters())),
        critic_opt=adam_init(dict(critic.named_parameters())),
        buffer=buffer_init(cfg.buffer_size, obs_dim, act_dim, device),
        env_state=bstate, obs=env.get_obs(env_params, bstate.env).float(),
    )


def _normals(draws: Optional[torch.Tensor], like: torch.Tensor,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    if draws is None:
        return torch.randn(like.shape, generator=generator, dtype=like.dtype, device=like.device)
    return draws.to(like.dtype)


def td3_train_step(env: Env, env_params: EnvParams, cfg: TD3Config, state: TD3State,
                   generator: Optional[torch.Generator] = None,
                   act_noise: Optional[torch.Tensor] = None,
                   env_noise: Optional[torch.Tensor] = None,
                   sample_idx: Optional[torch.Tensor] = None,
                   smooth_noise: Optional[torch.Tensor] = None):
    """One batched env step and `cfg.updates_per_step` TD3 updates, in place.

    Returns (state, metrics): the critic and actor losses as means over the
    updates and the step's mean episode return (0-d tensors on the
    device)."""
    with torch.no_grad():
        action = state.actor(state.obs)
        noise = cfg.explore_noise * _normals(act_noise, action, generator)
        action = torch.clamp(action + noise, -1.0, 1.0)
    bstate, rs = batched_step(env, env_params, state.env_state, action,
                              generator if env_noise is None else env_noise)
    next_obs = rs.obs.float()
    buffer_add(state.buffer, state.obs, action, rs.reward.float(), next_obs,
               true_done(rs, env_params).float())
    state.env_state, state.obs = bstate, next_obs

    history: List[Dict[str, torch.Tensor]] = []
    for u in range(cfg.updates_per_step):
        obs, act, rew, nobs, done = buffer_sample(state.buffer, cfg.batch_size, generator,
                                                  _draw(sample_idx, u))
        with torch.no_grad():
            nact = state.target_actor(nobs)
            smooth = torch.clamp(cfg.target_noise * _normals(_draw(smooth_noise, u), nact,
                                                             generator),
                                 -cfg.target_noise_clip, cfg.target_noise_clip)
            nact = torch.clamp(nact + smooth, -1.0, 1.0)
            tq1, tq2 = state.target_critic(nobs, nact)
            target_q = rew + cfg.gamma * (1.0 - done) * torch.minimum(tq1, tq2)
        q1, q2 = state.critic(obs, act)
        c_loss = ((q1 - target_q) ** 2 + (q2 - target_q) ** 2).mean()
        adam_apply(state.critic_opt, dict(state.critic.named_parameters()),
                   grads_of(c_loss, state.critic), cfg.lr, OPTAX_ADAM_EPS)

        # the actor's loss on every update, against the updated critic; its
        # gradient and step on every policy_delay-th
        step_actor = state.update_count % cfg.policy_delay == cfg.policy_delay - 1
        with torch.set_grad_enabled(step_actor):
            q1, _ = state.critic(obs, state.actor(obs))
            a_loss = -q1.mean()
        if step_actor:
            adam_apply(state.actor_opt, dict(state.actor.named_parameters()),
                       grads_of(a_loss, state.actor), cfg.lr, OPTAX_ADAM_EPS)
            soft_update(state.target_actor, state.actor, cfg.tau)
            soft_update(state.target_critic, state.critic, cfg.tau)
        state.update_count += 1
        history.append({"critic_loss": c_loss.detach(), "actor_loss": a_loss.detach()})

    metrics = {k: torch.stack([h[k] for h in history]).mean() for k in history[0]}
    metrics["episode_return"] = step_episode_return(rs)
    return state, metrics


def td3_train(env: Env, cfg: TD3Config, steps: int = 1000, seed: int = 0,
              env_params: Optional[EnvParams] = None, device=None):
    """Host loop over `td3_train_step` on `device` (default: the card), as
    `sac.sac_train`."""
    device = resolve(device)
    if env_params is None:
        env_params = env.params(device=device)
    state = make_td3_state(env, cfg, torch.Generator().manual_seed(seed), env_params, device)
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    history = []
    for i in range(steps):
        state, metrics = td3_train_step(env, env_params, cfg, state, generator)
        if i % 50 == 0 or i == steps - 1:
            history.append({k: float(v) for k, v in metrics.items()})
    return state, history


class TD3Policy:
    """sb3-style `.predict` over a trained TD3State."""

    def __init__(self, env: Env, state: TD3State):
        self.env = env
        self.state = state

    def act(self, obs, carried_harvest=None):
        with torch.no_grad():
            return self.state.actor(obs.float())

    def predict(self, obs, state=None, episode_start=None, deterministic=True):
        device = self.state.obs.device
        a = self.act(torch.as_tensor(np.asarray(obs, np.float32), device=device))
        return a.cpu().numpy(), state
