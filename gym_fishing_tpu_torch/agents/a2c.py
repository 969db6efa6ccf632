"""A2C learner: synchronous advantage actor-critic, one gradient step per
iteration.

Counterpart of ``gym_fishing_tpu/agents/a2c.py``. A2C is PPO's simpler
ancestor: one unclipped policy-gradient + value-regression step on the
freshly collected on-policy batch, with no epochs, no minibatches and no
ratio clipping. It reuses the PPO learner's network (`ActorCritic`), its
plain rollout (`collect_rollout`, with its injectable action and env noise)
and `compute_gae`, and swaps the optimizer for RMSProp (sb3's A2C default)
behind the global-norm clip.

The optimizer is optax's ``chain(clip_by_global_norm(max_grad_norm),
rmsprop(lr, decay=0.99, eps=1e-5))`` written by hand: ``nu = decay nu +
(1 - decay) g^2`` from ``nu = 0``, and the step ``-lr g / sqrt(nu + eps)``,
eps inside the square root, with no bias correction and no momentum.
``torch.optim.RMSprop`` adds eps outside the root and is not used.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from gym_fishing_tpu_torch.agents.ppo import (
    ActorCritic,
    PPOPolicy,
    _continuous,
    _episode_metrics,
    action_logp_entropy,
    clip_by_global_norm,
    collect_rollout,
    compute_gae,
)
from gym_fishing_tpu_torch.batch import BatchState, batched_reset
from gym_fishing_tpu_torch.core.env import Env
from gym_fishing_tpu_torch.core.types import EnvParams
from gym_fishing_tpu_torch.device import resolve

RMS_DECAY = 0.99
RMS_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class A2CConfig:
    num_envs: int = 1024
    num_steps: int = 16           # sb3 A2C n_steps=5 per env; batched here
    gamma: float = 0.99
    gae_lambda: float = 1.0       # sb3 A2C default: plain returns
    lr: float = 7e-4
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    max_grad_norm: float = 0.5
    hidden: int = 64
    normalize_advantage: bool = False  # sb3 A2C default (unlike PPO)
    compute_dtype: str = "float32"


@dataclasses.dataclass
class A2CState:
    """The network, RMSProp's second moments (keyed by parameter name) and
    the number of optimizer steps taken."""

    model: ActorCritic
    nu: Dict[str, torch.Tensor]
    step: int = 0

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def make_a2c_state(env: Env, cfg: A2CConfig, generator: Optional[torch.Generator] = None,
                   device=None) -> A2CState:
    """A fresh network (orthogonal init from the CPU `generator`) on `device`
    (default: the card) with RMSProp's moments at 0."""
    continuous = _continuous(env)
    model = ActorCritic(
        obs_dim=env.observation_space.shape[0],
        action_dim=1 if continuous else env.config.n_actions,
        continuous=continuous,
        hidden=cfg.hidden,
        compute_dtype=getattr(torch, cfg.compute_dtype),
        generator=generator,
    ).to(resolve(device))
    return A2CState(model=model, nu={n: torch.zeros_like(p) for n, p in model.named_parameters()})


def rmsprop_apply(state: A2CState, grads: Dict[str, torch.Tensor], cfg: A2CConfig) -> None:
    """optax.chain(clip_by_global_norm(max_grad_norm), rmsprop(lr, decay,
    eps)) in place."""
    grads = clip_by_global_norm(grads, cfg.max_grad_norm)
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            g = grads[name]
            nu = (1.0 - RMS_DECAY) * (g * g) + RMS_DECAY * state.nu[name]
            state.nu[name] = nu
            p.add_(torch.rsqrt(nu + RMS_EPS) * g * (-cfg.lr))
    state.step += 1


def a2c_loss(model: ActorCritic, cfg: A2CConfig, batch, continuous: bool):
    """(total, metrics) of one batch (obs, action, advantage, return). The
    advantage normalisation uses the population std, as jnp.std."""
    obs, action, adv, ret = batch
    dist, value = model(obs)
    logp, entropy = action_logp_entropy(dist, action, continuous)
    if cfg.normalize_advantage:
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg_loss = -(logp * adv).mean()          # unclipped policy gradient
    v_loss = 0.5 * ((value - ret) ** 2).mean()
    ent = entropy.mean()
    total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
    return total, {"loss": total, "pg_loss": pg_loss, "v_loss": v_loss, "entropy": ent}


def a2c_train_step(env: Env, env_params: EnvParams, cfg: A2CConfig, state: A2CState,
                   bstate: BatchState, generator: Optional[torch.Generator] = None,
                   act_noise: Optional[torch.Tensor] = None,
                   env_noise: Optional[torch.Tensor] = None):
    """One A2C iteration: rollout, GAE and one full-batch gradient step.

    Updates `state` in place and returns (state, bstate, metrics), the
    metrics as 0-d tensors on the device. `act_noise` [T, B, A] and
    `env_noise` [T, 2, B] replace the generator's draws, as in
    `ppo.collect_rollout`."""
    continuous = _continuous(env)
    bstate, _, traj, last_value = collect_rollout(env, env_params, cfg, state.model, bstate,
                                                  generator, act_noise, env_noise)
    advantages, returns = compute_gae(cfg, traj, last_value)

    def fl(x):
        return x.reshape((-1,) + tuple(x.shape[2:]))

    batch = (fl(traj.obs), fl(traj.action), fl(advantages), fl(returns))
    loss, metrics = a2c_loss(state.model, cfg, batch, continuous)
    names = [n for n, _ in state.model.named_parameters()]
    grads = torch.autograd.grad(loss, list(state.model.parameters()))
    rmsprop_apply(state, dict(zip(names, grads)), cfg)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics.update(_episode_metrics(traj))
    return state, bstate, metrics


def a2c_train(env: Env, cfg: A2CConfig, seed: int = 0, iterations: int = 32,
              env_params: Optional[EnvParams] = None, verbose: bool = False, device=None):
    """Host loop over `a2c_train_step` on `device` (default: the card): the
    network from a CPU generator seeded with `seed`, the rollout's draws
    from a generator on `device` seeded with `seed` + 1. Returns (state,
    history of float metrics per iteration)."""
    device = resolve(device)
    if env_params is None:
        env_params = env.params(device=device)
    state = make_a2c_state(env, cfg, torch.Generator().manual_seed(seed), device)
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    bstate = batched_reset(env, env_params, cfg.num_envs, device)
    history = []
    for it in range(iterations):
        state, bstate, metrics = a2c_train_step(env, env_params, cfg, state, bstate, generator)
        history.append({k: float(v) for k, v in metrics.items()})
        if verbose:
            print(f"iter {it}: {history[-1]}")
    return state, history


# The same network as PPO, so the predict wrapper is shared: PPOPolicy reads
# `.model` off the state it is given.
A2CPolicy = PPOPolicy
