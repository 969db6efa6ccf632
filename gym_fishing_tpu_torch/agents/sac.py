"""Soft Actor-Critic with a replay buffer on the device.

Counterpart of ``gym_fishing_tpu/agents/sac.py``: the off-policy member of
the sb3 family the reference's experiments train. One `sac_train_step` is
one batched env step, a wrapped insert of its transitions into the buffer,
and ``updates_per_step`` updates, each in the order critic, actor (against
the updated critic), temperature (on the actor's detached log-probs), then
the soft target update. Continuous-action envs only (tanh-squashed
Gaussian policy).

The buffer's ``ptr`` and ``size`` follow from the batch size alone, so they
are host ints: sampling's ``randint(0, max(size, 1))`` needs no sync, and
neither does anything else inside a step.

The three optimizers are optax's plain ``adam(lr)`` (eps 1e-8), each an
`AdamState` of moments keyed by parameter name and a host-int count. The
step's draws come from one `torch.Generator` and are injectable: the
action's normals ``act_noise [B, A]``, the env's ``env_noise [2, B]``, and
per update the sample indices ``sample_idx [U, batch]``, the target
action's normals ``target_noise [U, batch, A]`` and the actor loss's
``actor_noise [U, batch, A]``.

`ReplayBuffer`, `AdamState` and `DoubleCritic` are shared with the TD3 and
DQN learners, as in the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from gym_fishing_tpu_torch.agents.es import _lecun_linear
from gym_fishing_tpu_torch.agents.ppo import OPTAX_ADAM_EPS, adam_apply
from gym_fishing_tpu_torch.batch import BatchState, batched_reset, batched_step
from gym_fishing_tpu_torch.core.env import Env
from gym_fishing_tpu_torch.core.types import EnvParams
from gym_fishing_tpu_torch.device import resolve
from gym_fishing_tpu_torch.kernels.ppo_update_kernel import LOG_2PI

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


@dataclasses.dataclass(frozen=True)
class SACConfig:
    num_envs: int = 256
    buffer_size: int = 1 << 17        # transitions (device-resident)
    batch_size: int = 4096
    gamma: float = 0.99
    tau: float = 0.005                # target soft-update rate
    lr: float = 3e-4
    hidden: int = 64
    updates_per_step: int = 1
    target_entropy_scale: float = 1.0  # target entropy = -scale * act_dim
    init_alpha: float = 0.1


# ---------------------------------------------------------------- networks

class SquashedGaussianActor(nn.Module):
    """Two tanh layers (``d1``, ``d2``), a ``mean`` head and a ``log_std``
    head clipped to [LOG_STD_MIN, LOG_STD_MAX]."""

    def __init__(self, obs_dim: int, act_dim: int, hidden: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d1 = _lecun_linear(obs_dim, hidden, generator)
        self.d2 = _lecun_linear(hidden, hidden, generator)
        self.mean = _lecun_linear(hidden, act_dim, generator)
        self.log_std = _lecun_linear(hidden, act_dim, generator)

    def forward(self, obs: torch.Tensor):
        x = torch.tanh(self.d2(torch.tanh(self.d1(obs))))
        return self.mean(x), torch.clamp(self.log_std(x), LOG_STD_MIN, LOG_STD_MAX)


class DoubleCritic(nn.Module):
    """Two Q towers on ``[obs, act]``: ``q1_d1``, ``q1_d2``, ``q1_out`` and
    the same for ``q2``; returns (q1, q2), each [batch]."""

    def __init__(self, obs_dim: int, act_dim: int, hidden: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for q in ("q1", "q2"):
            setattr(self, f"{q}_d1", _lecun_linear(obs_dim + act_dim, hidden, generator))
            setattr(self, f"{q}_d2", _lecun_linear(hidden, hidden, generator))
            setattr(self, f"{q}_out", _lecun_linear(hidden, 1, generator))

    def _q(self, x: torch.Tensor, q: str) -> torch.Tensor:
        h = torch.tanh(getattr(self, f"{q}_d2")(torch.tanh(getattr(self, f"{q}_d1")(x))))
        return getattr(self, f"{q}_out")(h)[..., 0]

    def forward(self, obs: torch.Tensor, act: torch.Tensor):
        x = torch.cat([obs, act], dim=-1)
        return self._q(x, "q1"), self._q(x, "q2")


def sample_squashed(mean: torch.Tensor, log_std: torch.Tensor,
                    noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
    """Reparameterised tanh-Gaussian sample and its log-prob: ``noise`` is
    N(0, 1) shaped like the mean, drawn from `generator` when not given."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                            device=mean.device)
    act = torch.tanh(mean + torch.exp(log_std) * noise)
    logp = torch.sum(-0.5 * (noise ** 2 + 2 * log_std + LOG_2PI)
                     - torch.log(1.0 - act ** 2 + 1e-6), dim=-1)
    return act, logp


def soft_update(target: nn.Module, online: nn.Module, tau: float) -> None:
    """target <- (1 - tau) target + tau online, parameter by parameter."""
    with torch.no_grad():
        for t, o in zip(target.parameters(), online.parameters()):
            t.copy_((1 - tau) * t + tau * o)


# --------------------------------------------------------------- optimizer

@dataclasses.dataclass
class AdamState:
    """optax.adam's state: the moments keyed by parameter name and the
    update count (a host int)."""

    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    count: int = 0


def adam_init(params: Mapping[str, torch.Tensor]) -> AdamState:
    return AdamState(m={n: torch.zeros_like(p) for n, p in params.items()},
                     v={n: torch.zeros_like(p) for n, p in params.items()})


def grads_of(loss: torch.Tensor, module: nn.Module) -> Dict[str, torch.Tensor]:
    names, params = zip(*module.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, params)))


# ------------------------------------------------------------------ buffer

@dataclasses.dataclass
class ReplayBuffer:
    obs: torch.Tensor       # (cap, obs_dim)
    action: torch.Tensor    # (cap, act_dim)
    reward: torch.Tensor    # (cap,)
    next_obs: torch.Tensor  # (cap, obs_dim)
    done: torch.Tensor      # (cap,) float32 (1.0 = terminal, horizon truncation = 0)
    ptr: int = 0
    size: int = 0


def buffer_init(cap: int, obs_dim: int, act_dim: int, device=None) -> ReplayBuffer:
    """An empty buffer of `cap` float32 transitions on `device` (default:
    the card)."""
    device = resolve(device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return ReplayBuffer(obs=zeros(cap, obs_dim), action=zeros(cap, act_dim), reward=zeros(cap),
                        next_obs=zeros(cap, obs_dim), done=zeros(cap))


def buffer_add(buf: ReplayBuffer, obs, action, reward, next_obs, done) -> ReplayBuffer:
    """The batch's transitions into rows ``(ptr + i) % cap``, in place; the
    values cast to the buffer's float32. Returns the buffer."""
    B = obs.shape[0]
    cap = buf.obs.shape[0]
    idx = (torch.arange(B, device=buf.obs.device) + buf.ptr) % cap
    for name, x in (("obs", obs), ("action", action), ("reward", reward),
                    ("next_obs", next_obs), ("done", done)):
        store = getattr(buf, name)
        store[idx] = x.to(store.dtype)
    buf.ptr = (buf.ptr + B) % cap
    buf.size = min(buf.size + B, cap)
    return buf


def buffer_sample(buf: ReplayBuffer, batch: int, generator: Optional[torch.Generator] = None,
                  idx: Optional[torch.Tensor] = None):
    """`batch` rows drawn uniformly from the filled part (obs, action,
    reward, next_obs, done); `idx` replaces the draw."""
    if idx is None:
        idx = torch.randint(0, max(buf.size, 1), (batch,), generator=generator,
                            device=buf.obs.device)
    idx = idx.to(buf.obs.device).long()
    return buf.obs[idx], buf.action[idx], buf.reward[idx], buf.next_obs[idx], buf.done[idx]


def true_done(rs, env_params: EnvParams) -> torch.Tensor:
    """Terminals for the bootstrap: horizon truncation is not one."""
    return rs.done & (rs.episode_length < env_params.Tmax)


def step_episode_return(rs) -> torch.Tensor:
    """Mean return of the episodes that ended in this step (NaN if none)."""
    done_f = rs.done.float()
    n_done = done_f.sum()
    return torch.where(n_done > 0,
                       (rs.episode_return.float() * done_f).sum() / torch.clamp(n_done, min=1.0),
                       torch.full_like(n_done, float("nan")))


def _draw(draws: Optional[torch.Tensor], u: int):
    return None if draws is None else draws[u]


# ------------------------------------------------------------------- state

@dataclasses.dataclass
class SACState:
    actor: SquashedGaussianActor
    critic: DoubleCritic
    target_critic: DoubleCritic
    log_alpha: torch.Tensor        # 0-d
    actor_opt: AdamState
    critic_opt: AdamState
    alpha_opt: AdamState           # keyed "log_alpha"
    buffer: ReplayBuffer
    env_state: BatchState
    obs: torch.Tensor              # (num_envs, obs_dim) current observations


def _require_continuous(env: Env, name: str) -> None:
    if env.config.scheme != "continuous":
        raise ValueError(f"{name} supports continuous envs; {env.config.scheme!r} is discrete")


def make_sac_state(env: Env, cfg: SACConfig, generator: Optional[torch.Generator] = None,
                   env_params: Optional[EnvParams] = None, device=None) -> SACState:
    """Fresh networks (initialised from the CPU `generator`), an empty
    buffer and the reset envs on `device` (default: the card)."""
    _require_continuous(env, "SAC")
    device = resolve(device)
    if env_params is None:
        env_params = env.params(device=device)
    obs_dim, act_dim = env.observation_space.shape[0], 1
    actor = SquashedGaussianActor(obs_dim, act_dim, cfg.hidden, generator).to(device)
    critic = DoubleCritic(obs_dim, act_dim, cfg.hidden, generator).to(device)
    log_alpha = torch.tensor(np.log(cfg.init_alpha), dtype=torch.float32, device=device)
    bstate = batched_reset(env, env_params, cfg.num_envs, device)
    return SACState(
        actor=actor, critic=critic, target_critic=copy.deepcopy(critic),
        log_alpha=log_alpha,
        actor_opt=adam_init(dict(actor.named_parameters())),
        critic_opt=adam_init(dict(critic.named_parameters())),
        alpha_opt=adam_init({"log_alpha": log_alpha}),
        buffer=buffer_init(cfg.buffer_size, obs_dim, act_dim, device),
        env_state=bstate,
        obs=env.get_obs(env_params, bstate.env).float(),
    )


def sac_train_step(env: Env, env_params: EnvParams, cfg: SACConfig, state: SACState,
                   generator: Optional[torch.Generator] = None,
                   act_noise: Optional[torch.Tensor] = None,
                   env_noise: Optional[torch.Tensor] = None,
                   sample_idx: Optional[torch.Tensor] = None,
                   target_noise: Optional[torch.Tensor] = None,
                   actor_noise: Optional[torch.Tensor] = None):
    """One batched env step and `cfg.updates_per_step` SAC updates, in place.

    Returns (state, metrics): the update losses and alpha as means over the
    updates (0-d tensors on the device), the step's mean episode return and
    the buffer's size (a host int)."""
    with torch.no_grad():
        mean, log_std = state.actor(state.obs)
        action, _ = sample_squashed(mean, log_std, act_noise, generator)
    bstate, rs = batched_step(env, env_params, state.env_state, action,
                              generator if env_noise is None else env_noise)
    next_obs = rs.obs.float()
    buffer_add(state.buffer, state.obs, action, rs.reward.float(), next_obs,
               true_done(rs, env_params).float())
    state.env_state, state.obs = bstate, next_obs

    target_entropy = -cfg.target_entropy_scale * 1.0  # act_dim == 1
    history: List[Dict[str, torch.Tensor]] = []
    for u in range(cfg.updates_per_step):
        obs, act, rew, nobs, done = buffer_sample(state.buffer, cfg.batch_size, generator,
                                                  _draw(sample_idx, u))
        alpha = torch.exp(state.log_alpha.detach())

        # critic
        with torch.no_grad():
            nmean, nlog_std = state.actor(nobs)
            nact, nlogp = sample_squashed(nmean, nlog_std, _draw(target_noise, u), generator)
            tq1, tq2 = state.target_critic(nobs, nact)
            target_q = rew + cfg.gamma * (1.0 - done) * (torch.minimum(tq1, tq2) - alpha * nlogp)
        q1, q2 = state.critic(obs, act)
        c_loss = ((q1 - target_q) ** 2 + (q2 - target_q) ** 2).mean()
        adam_apply(state.critic_opt, dict(state.critic.named_parameters()),
                   grads_of(c_loss, state.critic), cfg.lr, OPTAX_ADAM_EPS)

        # actor, against the updated critic
        m, ls = state.actor(obs)
        a, logp = sample_squashed(m, ls, _draw(actor_noise, u), generator)
        q1, q2 = state.critic(obs, a)
        a_loss = (alpha * logp - torch.minimum(q1, q2)).mean()
        adam_apply(state.actor_opt, dict(state.actor.named_parameters()),
                   grads_of(a_loss, state.actor), cfg.lr, OPTAX_ADAM_EPS)

        # temperature, on the actor's detached log-probs
        la = state.log_alpha.detach().requires_grad_(True)
        al_loss = (-torch.exp(la) * (logp.detach() + target_entropy)).mean()
        (al_grad,) = torch.autograd.grad(al_loss, la)
        adam_apply(state.alpha_opt, {"log_alpha": state.log_alpha}, {"log_alpha": al_grad},
                   cfg.lr, OPTAX_ADAM_EPS)

        soft_update(state.target_critic, state.critic, cfg.tau)
        history.append({"critic_loss": c_loss.detach(), "actor_loss": a_loss.detach(),
                        "alpha": torch.exp(state.log_alpha), "alpha_loss": al_loss.detach()})

    metrics = {k: torch.stack([h[k] for h in history]).mean() for k in history[0]}
    metrics["episode_return"] = step_episode_return(rs)
    metrics["buffer_size"] = state.buffer.size
    return state, metrics


def sac_train(env: Env, cfg: SACConfig, steps: int = 1000, seed: int = 0,
              env_params: Optional[EnvParams] = None, device=None):
    """Host loop over `sac_train_step` on `device` (default: the card): the
    networks from a CPU generator seeded with `seed`, the step's draws from
    a generator on `device` seeded with `seed` + 1. Returns (state, history
    of float metrics every 50 steps and at the last)."""
    device = resolve(device)
    if env_params is None:
        env_params = env.params(device=device)
    state = make_sac_state(env, cfg, torch.Generator().manual_seed(seed), env_params, device)
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    history = []
    for i in range(steps):
        state, metrics = sac_train_step(env, env_params, cfg, state, generator)
        if i % 50 == 0 or i == steps - 1:
            history.append({k: float(v) for k, v in metrics.items()})
    return state, history


class SACPolicy:
    """sb3-style `.predict` over a trained SACState: the deterministic
    action tanh(mean)."""

    def __init__(self, env: Env, state: SACState):
        self.env = env
        self.state = state

    def act(self, obs, carried_harvest=None):
        with torch.no_grad():
            mean, _ = self.state.actor(obs.float())
        return torch.tanh(mean)

    def predict(self, obs, state=None, episode_start=None, deterministic=True):
        device = self.state.obs.device
        a = self.act(torch.as_tensor(np.asarray(obs, np.float32), device=device))
        return a.cpu().numpy(), state
