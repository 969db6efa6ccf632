"""Evolution Strategies learner (Salimans et al. 2017) on the batch engine.

Counterpart of ``gym_fishing_tpu/agents/es.py``. One generation: antithetic
perturbations of every parameter (a normal draw per parameter for the first
half of the population, mirrored for the second), a fixed-length rollout of
every member's policy over `envs_per_member` envs with an alive mask (the
first episode's return), centered-rank fitness shaping, the gradient
estimate ``E[shaped eps] / sigma`` and an update by optax's
``chain(add_decayed_weights(weight_decay), adam(lr))``: coupled L2, then
Adam.

The whole population steps as one batch of the engine, ``pop_size x
envs_per_member`` envs, member-major; each member's weights go through one
batched product per layer (`torch.baddbmm`), so no Python loop runs over
members. The perturbations and the per-step env draws can be injected
(`eps`, `env_noise`), which is how the tests feed the port JAX's own draws.

On the bistable May env every collapsing policy earns the same fitness, so
rank-based ES gets no signal there (see the JAX module); use the DP solver
or PPO.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from gym_fishing_tpu_torch.agents.ppo import OPTAX_ADAM_EPS, _continuous, adam_apply
from gym_fishing_tpu_torch.batch import batched_reset, batched_step
from gym_fishing_tpu_torch.core.env import Env
from gym_fishing_tpu_torch.core.types import EnvParams
from gym_fishing_tpu_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class ESConfig:
    pop_size: int = 256           # must be even (antithetic pairs)
    envs_per_member: int = 4      # rollouts averaged per perturbation
    sigma: float = 0.05           # perturbation scale
    lr: float = 0.02
    weight_decay: float = 0.005   # L2 pull toward 0 (Salimans et al.)
    rank_shaping: bool = True     # centered ranks in [-0.5, 0.5]
    hidden: int = 32
    episode_len: Optional[int] = None  # default: int(params.Tmax)

    def __post_init__(self):
        if self.pop_size % 2 != 0:
            raise ValueError("pop_size must be even for antithetic sampling")


def _lecun_linear(n_in: int, n_out: int, generator) -> nn.Linear:
    """flax Dense's default init: truncated-normal kernel of variance
    1 / fan_in, zero bias."""
    layer = nn.Linear(n_in, n_out)
    std = (1.0 / n_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
        layer.bias.zero_()
    return layer


class DeterministicPolicy(nn.Module):
    """Small tanh MLP, ``d1``, ``d2``, ``out``: the mean action (continuous)
    or the logits (argmax at act time); no value head, no distribution."""

    def __init__(self, obs_dim: int, action_dim: int, continuous: bool, hidden: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.continuous = continuous
        self.d1 = _lecun_linear(obs_dim, hidden, generator)
        self.d2 = _lecun_linear(hidden, hidden, generator)
        self.out = nn.Linear(hidden, action_dim)
        with torch.no_grad():
            nn.init.orthogonal_(self.out.weight, gain=0.01, generator=generator)
            self.out.bias.zero_()

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.out(torch.tanh(self.d2(torch.tanh(self.d1(obs)))))


def population_forward(pop_params: Dict[str, torch.Tensor], obs: torch.Tensor) -> torch.Tensor:
    """Every member's DeterministicPolicy on its own envs: `pop_params` maps
    the module's parameter names to [P, ...] stacks, `obs` is [P, E, D];
    returns [P, E, A]."""
    x = obs
    for layer in ("d1", "d2", "out"):
        w, b = pop_params[f"{layer}.weight"], pop_params[f"{layer}.bias"]
        x = torch.baddbmm(b[:, None, :], x, w.transpose(1, 2))
        if layer != "out":
            x = torch.tanh(x)
    return x


@dataclasses.dataclass
class ESState:
    """The policy, Adam's moments (keyed by parameter name) and the Adam
    count."""

    model: DeterministicPolicy
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    count: int = 0

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def make_es_state(env: Env, cfg: ESConfig, generator: Optional[torch.Generator] = None,
                  device=None) -> ESState:
    """A fresh policy (init from the CPU `generator`) on `device` (default:
    the card) with zero Adam moments."""
    continuous = _continuous(env)
    model = DeterministicPolicy(env.observation_space.shape[0],
                                1 if continuous else env.config.n_actions, continuous,
                                cfg.hidden, generator).to(resolve(device))
    zeros = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    return ESState(model=model, m=zeros, v={n: z.clone() for n, z in zeros.items()})


def _centered_ranks(fitness: torch.Tensor) -> torch.Tensor:
    """Fitness -> evenly spaced values in [-0.5, 0.5] by rank; ties keep
    their order (a stable sort, as jnp.argsort)."""
    n = fitness.shape[0]
    ranks = torch.argsort(torch.argsort(fitness, stable=True), stable=True)
    return ranks.to(torch.float32) / (n - 1) - 0.5


def _episode_returns(env: Env, env_params: EnvParams, pop_params: Dict[str, torch.Tensor],
                     continuous: bool, steps: int, num_envs: int,
                     noise=None) -> torch.Tensor:
    """Mean first-episode return of each member's policy over its `num_envs`
    envs: [P]. A fixed `steps`-long rollout of all P x num_envs envs
    (member-major) with an alive mask: rewards stop counting at the first
    done. `noise` is a generator or the env draws [steps, 2, P * num_envs]."""
    pop = next(iter(pop_params.values())).shape[0]
    n = pop * num_envs
    device = next(iter(pop_params.values())).device
    bstate = batched_reset(env, env_params, n, device)
    obs = env.get_obs(env_params, bstate.env)
    alive = torch.ones(n, dtype=torch.float32, device=device)
    acc = torch.zeros(n, dtype=torch.float32, device=device)
    with torch.no_grad():
        for t in range(steps):
            out = population_forward(pop_params, obs.float().reshape(pop, num_envs, -1))
            out = out.reshape(n, -1)
            action = out if continuous else torch.argmax(out, dim=-1).to(torch.int32)
            step_noise = noise[t] if isinstance(noise, torch.Tensor) else noise
            bstate, rs = batched_step(env, env_params, bstate, action, step_noise)
            acc = acc + rs.reward.float() * alive
            alive = alive * (1.0 - rs.done.float())
            obs = rs.obs
    return acc.reshape(pop, num_envs).mean(dim=1)


def es_train_step(env: Env, env_params: EnvParams, cfg: ESConfig, steps: int, state: ESState,
                  generator: Optional[torch.Generator] = None,
                  eps: Optional[Dict[str, torch.Tensor]] = None,
                  env_noise: Optional[torch.Tensor] = None):
    """One ES generation; updates `state` in place and returns (state,
    metrics as 0-d tensors). `eps` maps each parameter name to the first
    half's normal draws [pop_size / 2, *shape] (the second half mirrors
    them); `env_noise` [steps, 2, pop_size * envs_per_member] replaces the
    env's draws. Both come from `generator` when not given."""
    continuous = _continuous(env)
    params = dict(state.model.named_parameters())
    half = cfg.pop_size // 2
    if eps is None:
        eps = {n: torch.randn((half,) + tuple(p.shape), generator=generator, device=p.device)
               for n, p in params.items()}
    eps = {n: torch.cat([e, -e]) for n, e in eps.items()}
    with torch.no_grad():
        pop_params = {n: p[None] + cfg.sigma * eps[n] for n, p in params.items()}
    fitness = _episode_returns(env, env_params, pop_params, continuous, steps,
                               cfg.envs_per_member,
                               generator if env_noise is None else env_noise)
    if cfg.rank_shaping:
        shaped = _centered_ranks(fitness)
    else:
        shaped = (fitness - fitness.mean()) / (fitness.std(correction=0) + 1e-8)
    # gradient ascent on fitness: Adam minimizes, so it gets -g, after
    # add_decayed_weights' coupled L2
    grads = {n: -(torch.tensordot(shaped, eps[n], dims=1) / (cfg.pop_size * cfg.sigma))
             + cfg.weight_decay * p.detach() for n, p in params.items()}
    adam_apply(state, params, grads, cfg.lr, OPTAX_ADAM_EPS)
    metrics = {"fitness_mean": fitness.mean(), "fitness_max": fitness.max(),
               "fitness_std": fitness.std(correction=0)}
    return state, metrics


def es_train(env: Env, cfg: ESConfig, seed: int = 0, generations: int = 50,
             env_params: Optional[EnvParams] = None, verbose: bool = False, device=None):
    """Host loop over `es_train_step` on `device` (default: the card): the
    policy from a CPU generator seeded with `seed`, the perturbations and the
    env's draws from a generator on `device` seeded with `seed` + 1. Returns
    (state, history of float metrics per generation)."""
    device = resolve(device)
    if env_params is None:
        env_params = env.params(device=device)
    steps = cfg.episode_len or int(torch.as_tensor(env_params.Tmax))
    state = make_es_state(env, cfg, torch.Generator().manual_seed(seed), device)
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    history = []
    for gen in range(generations):
        state, metrics = es_train_step(env, env_params, cfg, steps, state, generator)
        history.append({k: float(v) for k, v in metrics.items()})
        if verbose:
            print(f"gen {gen}: {history[-1]}")
    return state, history


class ESPolicy:
    """`.predict` wrapper over the trained deterministic policy: the output
    (continuous) or its argmax class."""

    def __init__(self, env: Env, state: ESState):
        self.env = env
        self.state = state
        self.continuous = _continuous(env)

    def act(self, obs, carried_harvest=None):
        with torch.no_grad():
            out = self.state.model(obs.float())
        if self.continuous:
            return out
        return torch.argmax(out, dim=-1).to(torch.int32)

    def predict(self, obs, state=None, episode_start=None, deterministic=True):
        device = next(self.state.model.parameters()).device
        a = self.act(torch.as_tensor(np.asarray(obs), device=device))
        return a.cpu().numpy(), state
