"""Recurrent PPO (GRU actor-critic) for the partially observed variants.

Counterpart of ``gym_fishing_tpu/agents/ppo_rnn.py``. Frame stacking
(`envs/wrappers.ObsStackEnv`) is the cheap POMDP remedy; this one carries a
learned belief state across the episode in a GRU, so a policy can filter
observation noise (``sigma_m > 0``), infer the latent growth model or track
a drifting productivity.

- Collection is `agents/ppo.py`'s rollout with the hidden state carried
  beside the batch state and zeroed after a done step.
- The update replays whole ``[T, B_mb]`` segments through the GRU
  (truncated BPTT over the rollout): minibatches cut the env axis only, so
  the recurrence stays intact, and the same permutation takes the hidden
  states the segments started from.
- GAE, the distributions, the clipped loss's arithmetic and Adam come from
  `agents/ppo.py`; the optimizer is optax's ``chain(clip_by_global_norm(
  max_grad_norm), adam(lr, eps=1e-5))`` written by hand.

The GRU is flax's ``GRUCell``: ``r = sigmoid(ir(x) + hr(h))``, ``z =
sigmoid(iz(x) + hz(h))``, ``n = tanh(in(x) + r * hn(h))``, ``h' = (1 - z) n
+ z h``, where ``ir``, ``iz``, ``in`` and ``hn`` have a bias and ``hr`` and
``hz`` none. `GRUCell` holds it in `torch.nn.GRUCell`'s layout (gates in the
order r, z, n) with the one recurrent bias it has, ``bias_hn``, so that
Adam steps no parameter the flax cell lacks.

Randomness: the rollout's draws (action normals or Gumbel noise, the env's
(2, B) plane per step) and one permutation of the envs per epoch come from
one `torch.Generator`; ``act_noise [T, B, A]``, ``env_noise [T, 2, B]`` and
``perms`` replace them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gym_fishing_tpu_torch.agents.es import _lecun_linear
from gym_fishing_tpu_torch.agents.ppo import (
    TrainState,
    Transition,
    _continuous,
    _episode_metrics,
    _orthogonal_linear,
    action_logp_entropy,
    adam_apply,
    clip_by_global_norm,
    compute_gae,
    sample_action,
)
from gym_fishing_tpu_torch.batch import BatchState, batched_reset, batched_step
from gym_fishing_tpu_torch.core.env import Env
from gym_fishing_tpu_torch.core.types import EnvParams
from gym_fishing_tpu_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class RPPOConfig:
    num_envs: int = 256
    num_steps: int = 64          # BPTT segment length
    epochs: int = 4
    num_minibatches: int = 4     # cuts across envs; num_envs % this == 0
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    hidden: int = 64             # GRU width (also the obs embedding width)


class GRUCell(nn.Module):
    """flax's GRUCell in `torch.nn.GRUCell`'s layout: ``weight_ih [3H, in]``
    and ``bias_ih [3H]`` (gates r, z, n), ``weight_hh [3H, H]`` and the
    candidate gate's recurrent bias ``bias_hn [H]``. Initialised as flax's:
    truncated-normal input kernels of variance 1 / fan_in, an orthogonal
    recurrent kernel per gate, zero biases."""

    def __init__(self, input_size: int, hidden: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.cat(
            [_lecun_linear(input_size, hidden, generator).weight.detach() for _ in range(3)]))
        w_hh = torch.empty(3 * hidden, hidden)
        for g in range(3):
            nn.init.orthogonal_(w_hh[g * hidden:(g + 1) * hidden], generator=generator)
        self.weight_hh = nn.Parameter(w_hh)
        self.bias_ih = nn.Parameter(torch.zeros(3 * hidden))
        self.bias_hn = nn.Parameter(torch.zeros(hidden))

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        i_r, i_z, i_n = F.linear(x, self.weight_ih, self.bias_ih).chunk(3, dim=-1)
        h_r, h_z, h_n = F.linear(h, self.weight_hh).chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * (h_n + self.bias_hn))
        return (1.0 - z) * n + z * h


class RecurrentActorCritic(nn.Module):
    """``embed`` (tanh) -> ``gru`` -> a ``v_out`` head and a ``pi_mean``
    head with a free ``log_std`` (continuous) or a ``pi_logits`` head.
    ``forward(obs, h) -> (dist, value, h_next)``."""

    def __init__(self, obs_dim: int, action_dim: int, continuous: bool, hidden: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.continuous = continuous
        self.embed = _orthogonal_linear(obs_dim, hidden, math.sqrt(2.0), generator)
        self.gru = GRUCell(hidden, hidden, generator)
        self.v_out = _orthogonal_linear(hidden, 1, 1.0, generator)
        if continuous:
            self.pi_mean = _orthogonal_linear(hidden, action_dim, 0.01, generator)
            self.log_std = nn.Parameter(torch.zeros(action_dim))
        else:
            self.pi_logits = _orthogonal_linear(hidden, action_dim, 0.01, generator)

    def forward(self, obs: torch.Tensor, h: torch.Tensor):
        h = self.gru(torch.tanh(self.embed(obs)), h)
        value = self.v_out(h)[..., 0]
        if self.continuous:
            return (self.pi_mean(h), self.log_std), value, h
        return (self.pi_logits(h),), value, h


def init_hidden(cfg: RPPOConfig, batch: int, device=None) -> torch.Tensor:
    return torch.zeros((batch, cfg.hidden), dtype=torch.float32, device=resolve(device))


def make_rppo_state(env: Env, cfg: RPPOConfig, generator: Optional[torch.Generator] = None,
                    device=None) -> TrainState:
    """A fresh network (initialised from the CPU `generator`) on `device`
    (default: the card) with zero Adam moments."""
    continuous = _continuous(env)
    model = RecurrentActorCritic(
        obs_dim=env.observation_space.shape[0],
        action_dim=1 if continuous else env.config.n_actions,
        continuous=continuous,
        hidden=cfg.hidden,
        generator=generator,
    ).to(resolve(device))
    zeros = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    return TrainState(model=model, m=zeros, v={n: z.clone() for n, z in zeros.items()})


def apply_gradients(ts: TrainState, grads: Dict[str, torch.Tensor], cfg: RPPOConfig) -> None:
    """optax.chain(clip_by_global_norm(max_grad_norm), adam(lr, eps=1e-5))
    in place."""
    adam_apply(ts, dict(ts.model.named_parameters()),
               clip_by_global_norm(grads, cfg.max_grad_norm), cfg.lr)
    ts.step += 1


# the same time-major record as the feed-forward learner's
RTransition = Transition


def _zero_done(h: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
    """The episode boundary: the step after a done one starts from h = 0."""
    return torch.where(done[:, None], torch.zeros_like(h), h)


def collect_rollout(env: Env, env_params: EnvParams, cfg: RPPOConfig,
                    model: RecurrentActorCritic, bstate: BatchState, h0: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    act_noise: Optional[torch.Tensor] = None,
                    env_noise: Optional[torch.Tensor] = None):
    """`cfg.num_steps` steps carrying the GRU hidden, zeroed after a done step.

    Returns (bstate, obs_last, h_last, h_start, traj, last_value), `h_start`
    the hidden state the segment started with (the update replays from it)
    and `traj` a time-major RTransition."""
    continuous = _continuous(env)
    obs = env.get_obs(env_params, bstate.env).float()
    h = h0
    steps = []
    with torch.no_grad():
        for t in range(cfg.num_steps):
            dist, value, h_next = model(obs, h)
            action, logp = sample_action(dist, continuous,
                                         None if act_noise is None else act_noise[t], generator)
            env_action = action if continuous else action.to(torch.int32)
            noise = generator if env_noise is None else env_noise[t]
            bstate, rs = batched_step(env, env_params, bstate, env_action, noise)
            h = _zero_done(h_next, rs.done)
            steps.append(RTransition(
                obs=obs, action=action, logp=logp, value=value,
                reward=rs.reward.float(), done=rs.done,
                episode_return=rs.episode_return.float(), episode_length=rs.episode_length,
            ))
            obs = rs.obs.float()
        _, last_value, _ = model(obs, h)
    traj = RTransition(**{
        f.name: torch.stack([getattr(s, f.name) for s in steps])
        for f in dataclasses.fields(RTransition)
    })
    return bstate, obs, h, h0, traj, last_value


def replay_sequence(model: RecurrentActorCritic, obs_seq: torch.Tensor, done_seq: torch.Tensor,
                    h0: torch.Tensor):
    """Re-run the GRU over a ``[T, B, ...]`` segment with the collection's
    reset convention -> (dist leaves stacked over time, values [T, B]). The
    Gaussian head's shared ``log_std`` is broadcast to the mean's shape, so
    every leaf is ``[T, B, A]``."""
    h = h0
    leaves: List[tuple] = []
    values = []
    for t in range(obs_seq.shape[0]):
        dist, value, h_next = model(obs_seq[t], h)
        if len(dist) == 2:
            dist = (dist[0], dist[1].expand_as(dist[0]))
        leaves.append(dist)
        values.append(value)
        h = _zero_done(h_next, done_seq[t])
    dists = tuple(torch.stack(leaf) for leaf in zip(*leaves))
    return dists, torch.stack(values)


def rppo_loss(model: RecurrentActorCritic, cfg: RPPOConfig, batch, continuous: bool):
    """Clipped PPO loss over a replayed ``[T, B_mb]`` sequence -> (total,
    metrics); the advantage normalisation uses the population std."""
    obs, action, done, old_logp, old_value, adv, ret, h0 = batch
    dists, value = replay_sequence(model, obs, done, h0)
    logp, entropy = action_logp_entropy(dists, action, continuous)
    ratio = torch.exp(logp - old_logp)
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg1 = ratio * adv_n
    pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n
    pg_loss = -torch.minimum(pg1, pg2).mean()
    v_clipped = old_value + torch.clamp(value - old_value, -cfg.clip_eps, cfg.clip_eps)
    v_loss = 0.5 * torch.maximum((value - ret) ** 2, (v_clipped - ret) ** 2).mean()
    ent = entropy.mean()
    total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
    return total, {"loss": total, "pg_loss": pg_loss, "v_loss": v_loss, "entropy": ent,
                   "approx_kl": ((ratio - 1) - torch.log(ratio)).mean()}


def train_step(env: Env, env_params: EnvParams, cfg: RPPOConfig, ts: TrainState,
               bstate: BatchState, h: torch.Tensor, generator: Optional[torch.Generator] = None,
               perms: Optional[Sequence[torch.Tensor]] = None,
               act_noise: Optional[torch.Tensor] = None,
               env_noise: Optional[torch.Tensor] = None):
    """One recurrent-PPO iteration: rollout, GAE, and ``epochs x
    num_minibatches`` replayed updates, each minibatch ``num_envs /
    num_minibatches`` whole env segments.

    Updates `ts` in place and returns (ts, bstate, h_last, metrics), the
    metrics as 0-d tensors on the device. `perms` holds one permutation of
    the envs per epoch."""
    if cfg.num_envs % cfg.num_minibatches:
        raise ValueError(f"num_envs {cfg.num_envs} is not a multiple of num_minibatches "
                         f"{cfg.num_minibatches}")
    if perms is not None and len(perms) != cfg.epochs:
        raise ValueError(f"perms needs one permutation per epoch ({cfg.epochs})")
    continuous = _continuous(env)
    bstate, _, h_last, h_start, traj, last_value = collect_rollout(
        env, env_params, cfg, ts.model, bstate, h, generator, act_noise, env_noise)
    advantages, returns = compute_gae(cfg, traj, last_value)
    mb_envs = cfg.num_envs // cfg.num_minibatches
    seqs = (traj.obs, traj.action, traj.done, traj.logp, traj.value, advantages, returns)
    names = [n for n, _ in ts.model.named_parameters()]
    history = []
    for e in range(cfg.epochs):
        perm = perms[e] if perms is not None else torch.randperm(
            cfg.num_envs, generator=generator, device=h_start.device)
        perm = perm.to(h_start.device).long()
        shuffled = [x[:, perm] for x in seqs] + [h_start[perm]]
        for i in range(cfg.num_minibatches):
            cut = slice(i * mb_envs, (i + 1) * mb_envs)
            batch = tuple(x[:, cut] for x in shuffled[:-1]) + (shuffled[-1][cut],)
            loss, mets = rppo_loss(ts.model, cfg, batch, continuous)
            grads = torch.autograd.grad(loss, list(ts.model.parameters()))
            apply_gradients(ts, dict(zip(names, grads)), cfg)
            history.append({k: v.detach() for k, v in mets.items()})
    metrics = {k: torch.stack([m[k] for m in history]).mean() for k in history[0]}
    metrics["episode_return"] = _episode_metrics(traj)["episode_return"]
    return ts, bstate, h_last, metrics


def train(env: Env, cfg: RPPOConfig, iterations: int = 32, seed: int = 0,
          env_params: Optional[EnvParams] = None, verbose: bool = False, device=None):
    """Host loop over `train_step` on `device` (default: the card): the
    network from a CPU generator seeded with `seed`, the rollout's draws
    and the permutations from a generator on `device` seeded with `seed` +
    1. Returns (ts, history of float metrics per iteration)."""
    device = resolve(device)
    if env_params is None:
        env_params = env.params(device=device)
    ts = make_rppo_state(env, cfg, torch.Generator().manual_seed(seed), device)
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    bstate = batched_reset(env, env_params, cfg.num_envs, device)
    h = init_hidden(cfg, cfg.num_envs, device)
    history = []
    for it in range(iterations):
        ts, bstate, h, metrics = train_step(env, env_params, cfg, ts, bstate, h, generator)
        history.append({k: float(v) for k, v in metrics.items()})
        if verbose:
            print(f"iter {it}: {history[-1]}")
    return ts, history


class RecurrentPPOPolicy:
    """sb3-style `.predict`; the state slot carries the GRU hidden. It has
    no `.act`, so `analysis.simulate_mdp` takes its host `.predict` loop,
    which threads the state from step to step."""

    def __init__(self, env: Env, ts: TrainState, cfg: RPPOConfig):
        self.env = env
        self.ts = ts
        self.cfg = cfg
        self.continuous = _continuous(env)

    def predict(self, obs, state=None, episode_start=None, deterministic=True):
        """(action, hidden) as numpy: the mean action or the argmax class,
        from `state` (zeros when None) with the rows of `episode_start`
        reset to zero first."""
        del deterministic
        device = next(self.ts.model.parameters()).device
        obs = torch.as_tensor(np.asarray(obs, np.float32), device=device)
        h = (init_hidden(self.cfg, obs.shape[0], device) if state is None
             else torch.as_tensor(np.asarray(state, np.float32), device=device))
        if episode_start is not None:
            start = torch.as_tensor(np.asarray(episode_start, bool), device=device)
            h = _zero_done(h, start)
        with torch.no_grad():
            dist, _, h = self.ts.model(obs, h)
        action = dist[0] if self.continuous else torch.argmax(dist[0], dim=-1).to(torch.int32)
        return action.cpu().numpy(), h.cpu().numpy()
