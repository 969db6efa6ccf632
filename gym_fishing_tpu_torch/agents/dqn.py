"""Double-DQN learner for the discrete-action envs (fishing-v0 family).

Counterpart of ``gym_fishing_tpu/agents/dqn.py``: the reference trains its
discrete envs with sb3's DQN. One `dqn_train_step` is one batched
epsilon-greedy env step, a wrapped insert into SAC's replay buffer
(``agents/sac.py``), and ``updates_per_step`` Huber-loss updates against
double-Q targets with a soft target update.

Both discrete decode schemes work. Under the relative scheme the stock
observation alone is not Markov (the effective action depends on the
carried harvest), so the Q-network reads the observation with the carried
harvest / K appended (`_augment`), taken from the batch state after the step
and its auto-reset.

Exploration uses epsilon at the env-step count before the step; the metric
reports it after. The count is a host int and epsilon a host float32
number. Injectable draws: ``explore_u [B]`` (uniforms against epsilon),
``rand_actions [B]``, ``env_noise [2, B]`` and ``sample_idx [U, batch]``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gym_fishing_tpu_torch.agents.es import _lecun_linear
from gym_fishing_tpu_torch.agents.ppo import OPTAX_ADAM_EPS, adam_apply
from gym_fishing_tpu_torch.agents.sac import (
    AdamState,
    ReplayBuffer,
    _draw,
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
from gym_fishing_tpu_torch.spaces.scaling import decode_action


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    num_envs: int = 256
    buffer_size: int = 1 << 17
    batch_size: int = 4096
    gamma: float = 0.99
    tau: float = 0.01                # soft target-update rate
    lr: float = 3e-4
    hidden: int = 64
    updates_per_step: int = 1
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 2000      # env steps to anneal epsilon over
    double: bool = True              # double-DQN action selection


class QNetwork(nn.Module):
    """Two ReLU layers (``d1``, ``d2``) and one Q-value per action (``out``)."""

    def __init__(self, obs_dim: int, n_actions: int, hidden: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d1 = _lecun_linear(obs_dim, hidden, generator)
        self.d2 = _lecun_linear(hidden, hidden, generator)
        self.out = _lecun_linear(hidden, n_actions, generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.out(torch.relu(self.d2(torch.relu(self.d1(obs)))))


@dataclasses.dataclass
class DQNState:
    q: QNetwork
    target_q: QNetwork
    opt: AdamState
    buffer: ReplayBuffer
    env_state: BatchState
    obs: torch.Tensor      # (num_envs, obs_dim + 1) float32, augmented
    step: int = 0          # env steps taken (for the epsilon anneal)


def _augment(env_params: EnvParams, obs: torch.Tensor, harvest: torch.Tensor) -> torch.Tensor:
    """Q-network input: [obs, carried_harvest / K] (Markov for all schemes)."""
    h = (harvest / env_params.K).float()
    return torch.cat([obs.float(), h[:, None]], dim=-1)


def _epsilon(cfg: DQNConfig, step: int) -> float:
    """The linear anneal at env step `step`, in float32 arithmetic."""
    f32 = np.float32
    frac = np.clip(f32(step) / f32(cfg.eps_decay_steps), f32(0.0), f32(1.0))
    return float(f32(cfg.eps_start) + frac * f32(cfg.eps_end - cfg.eps_start))


def make_dqn_state(env: Env, cfg: DQNConfig, generator: Optional[torch.Generator] = None,
                   env_params: Optional[EnvParams] = None, device=None) -> DQNState:
    """A fresh Q-network (initialised from the CPU `generator`), an empty
    buffer and the reset envs on `device` (default: the card)."""
    if env.config.scheme == "continuous":
        raise ValueError("DQN needs a discrete action space; the env's is continuous")
    device = resolve(device)
    if env_params is None:
        env_params = env.params(device=device)
    obs_dim = env.observation_space.shape[0] + 1  # + carried-harvest feature
    q = QNetwork(obs_dim, env.config.n_actions, cfg.hidden, generator).to(device)
    bstate = batched_reset(env, env_params, cfg.num_envs, device)
    obs = env.get_obs(env_params, bstate.env)
    return DQNState(
        q=q, target_q=copy.deepcopy(q), opt=adam_init(dict(q.named_parameters())),
        buffer=buffer_init(cfg.buffer_size, obs_dim, 1, device),
        env_state=bstate, obs=_augment(env_params, obs, bstate.env.harvest),
    )


def dqn_train_step(env: Env, env_params: EnvParams, cfg: DQNConfig, state: DQNState,
                   generator: Optional[torch.Generator] = None,
                   explore_u: Optional[torch.Tensor] = None,
                   rand_actions: Optional[torch.Tensor] = None,
                   env_noise: Optional[torch.Tensor] = None,
                   sample_idx: Optional[torch.Tensor] = None) -> Tuple[DQNState, Dict]:
    """One batched epsilon-greedy env step and `cfg.updates_per_step`
    updates, in place. Returns (state, metrics): the loss (mean over the
    updates) and the step's mean episode return as 0-d tensors on the
    device, and epsilon after the step (a host float)."""
    n_actions = env.config.n_actions
    device = state.obs.device
    with torch.no_grad():
        greedy = torch.argmax(state.q(state.obs), dim=-1).to(torch.int32)
    if rand_actions is None:
        rand_actions = torch.randint(0, n_actions, greedy.shape, generator=generator,
                                     device=device)
    if explore_u is None:
        explore_u = torch.rand(greedy.shape, generator=generator, device=device)
    explore = explore_u.to(device) < _epsilon(cfg, state.step)
    action = torch.where(explore, rand_actions.to(device=device, dtype=torch.int32), greedy)

    bstate, rs = batched_step(env, env_params, state.env_state, action,
                              generator if env_noise is None else env_noise)
    next_obs = _augment(env_params, rs.obs, bstate.env.harvest)
    buffer_add(state.buffer, state.obs, action[:, None], rs.reward, next_obs,
               true_done(rs, env_params))
    state.env_state, state.obs = bstate, next_obs
    state.step += 1

    history: List[torch.Tensor] = []
    for u in range(cfg.updates_per_step):
        obs, act, rew, nobs, done = buffer_sample(state.buffer, cfg.batch_size, generator,
                                                  _draw(sample_idx, u))
        with torch.no_grad():
            nq_target = state.target_q(nobs)
            a_star = torch.argmax(state.q(nobs) if cfg.double else nq_target, dim=-1)
            next_v = nq_target.gather(-1, a_star[:, None])[:, 0]
            target = rew + cfg.gamma * (1.0 - done) * next_v
        q_sa = state.q(obs).gather(-1, act.long())[:, 0]
        loss = F.huber_loss(q_sa, target, delta=1.0)
        adam_apply(state.opt, dict(state.q.named_parameters()), grads_of(loss, state.q), cfg.lr,
                   OPTAX_ADAM_EPS)
        soft_update(state.target_q, state.q, cfg.tau)
        history.append(loss.detach())

    return state, {"loss": torch.stack(history).mean(),
                   "episode_return": step_episode_return(rs),
                   "epsilon": _epsilon(cfg, state.step)}


def dqn_train(env: Env, cfg: DQNConfig, steps: int = 1000, seed: int = 0,
              env_params: Optional[EnvParams] = None, warmup_steps: int = 10, device=None):
    """Host loop over `dqn_train_step` on `device` (default: the card): the
    network from a CPU generator seeded with `seed`, the draws from a
    generator on `device` seeded with `seed` + 1; `warmup_steps` steps
    first (epsilon near 1) fill the buffer. Returns (state, history of
    float metrics per step after the warm-up)."""
    device = resolve(device)
    if env_params is None:
        env_params = env.params(device=device)
    state = make_dqn_state(env, cfg, torch.Generator().manual_seed(seed), env_params, device)
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    for _ in range(warmup_steps):
        state, _ = dqn_train_step(env, env_params, cfg, state, generator)
    history = []
    for _ in range(steps):
        state, metrics = dqn_train_step(env, env_params, cfg, state, generator)
        history.append({k: float(v) for k, v in metrics.items()})
    return state, history


class DQNPolicy:
    """The greedy policy of the learned Q-network (sb3 `.predict`
    contract). Under the relative scheme the sb3 "recurrent state" slot
    carries the policy's view of the carried harvest, as the baseline
    policies' does."""

    def __init__(self, env: Env, state: DQNState, env_params: Optional[EnvParams] = None):
        self.env = env
        self.state = state
        self.device = state.obs.device
        self.params = (env_params if env_params is not None
                       else env.params(device=self.device))

    def act(self, obs, carried_harvest=None):
        obs = obs.float()
        if carried_harvest is None:
            carried_harvest = torch.full(obs.shape[:-1], float(self.params.init_harvest),
                                         device=obs.device)
        with torch.no_grad():
            q = self.state.q(_augment(self.params, obs, carried_harvest))
        return torch.argmax(q, dim=-1).to(torch.int32)

    def predict(self, obs, state=None, episode_start=None, deterministic=True):
        del episode_start, deterministic
        obs = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        carried = (torch.full(obs.shape[:-1], float(self.params.init_harvest),
                              device=self.device)
                   if state is None
                   else torch.as_tensor(np.asarray(state, np.float32), device=self.device))
        action = self.act(obs, carried)
        if self.env.config.scheme == "relative":
            _, new_h = decode_action(self.env.config, self.params, carried, action)
            return action.cpu().numpy(), new_h.cpu().numpy()
        return action.cpu().numpy(), None
