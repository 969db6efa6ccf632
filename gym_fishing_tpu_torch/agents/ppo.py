"""PPO learner on the batched env engine.

Counterpart of ``gym_fishing_tpu/agents/ppo.py``. One iteration is
`collect_rollout` (policy forward, sampling, batched step with auto-reset),
`compute_gae`, packing into one ``[N, C]`` sample matrix, and
``epochs x num_minibatches`` clipped-PPO updates, in one of these forms:

- plain (``fused_update=False``): `ppo_loss` under autograd, then
  clip-by-global-norm and Adam written by hand to optax's semantics
  (`apply_gradients`);
- fused update (``fused_update=True``): every minibatch gradient through the
  fused update kernel K2 (``agents/ppo_fused.fused_epoch_scan``), or with
  ``fused_adam`` gradient + clip + Adam through K3
  (``fused_epoch_scan_adam``);
- fused rollout (``fused_rollout=True``, with ``fused_update``): rollout,
  GAE and packing in one launch of the policy-rollout kernel K4
  (``agents/ppo_fused.fused_rollout_collect``), whose packed output feeds
  K2 or K3 directly.

Randomness comes from one `torch.Generator` on the rollout's device: action
normals (Gaussian head) or Gumbel noise (categorical head, Gumbel-max
sampling), the env's (2, B) noise plane per step, and one permutation per
epoch; the fused rollout takes its Philox seed and offset from the same
generator's state. Parity tests inject all of them instead: ``act_noise
[T, B, A]``, ``env_noise [T, 2, B]`` (plain rollout), ``rollout_noise``
(the fused rollout's planes) and ``perms`` (one permutation per epoch: of
the N samples in the plain form, of the tiles in the fused forms).

The Adam count is a Python int, so the learning rate and the bias
corrections are host numbers and an iteration queues on the device without
a host sync until `train` reads its metrics.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import TYPE_CHECKING, Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from gym_fishing_tpu_torch.batch import BatchState, batched_reset, batched_step
from gym_fishing_tpu_torch.core.env import Env
from gym_fishing_tpu_torch.core.types import EnvParams
from gym_fishing_tpu_torch.device import resolve
from gym_fishing_tpu_torch.kernels.ppo_update_kernel import (
    ADAM_B1,
    ADAM_B2,
    ADAM_EPS,
    LOG_2PI,
    LOG_2PI_E,
)

if TYPE_CHECKING:
    from gym_fishing_tpu_torch.shard.mesh import Mesh

OPTAX_ADAM_EPS = 1e-8   # optax.adam's default


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    num_envs: int = 1024
    num_steps: int = 128          # rollout length per iteration
    epochs: int = 4
    num_minibatches: int = 8
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    lr: float = 3e-4
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    max_grad_norm: float = 0.5
    hidden: int = 64
    anneal_lr: bool = False
    total_iterations: int = 64    # used only for lr annealing
    # "bfloat16": the two hidden layers of each tower compute in bf16 (plain
    # form) or the kernel's three 2H-contractions take bf16 inputs (fused)
    compute_dtype: str = "float32"
    # every minibatch gradient through the fused update kernel (K2)
    fused_update: bool = False
    # with fused_update: rollout + GAE + packing in one launch of the
    # policy-rollout kernel (K4); scalar observations only
    fused_rollout: bool = False
    # accepted for config parity and changes no value: the port's rollout
    # noise is counter-based (Philox), so drawing it ahead of the steps or
    # inside them gives the same numbers, and the kernel draws inside
    rollout_pregen_noise: bool = True
    # K4 feeds the clipped raw measurement through w1/K, b1 - w1 instead of
    # the obs (equal up to float32 rounding)
    rollout_fold_obs: bool = True
    # a TPU ablation of the GAE pass; not ported, raises
    rollout_vector_gae: bool = False
    # with fused_update: gradient + clip + Adam in one kernel per minibatch
    # (K3); the optimizer state is read and written once per train step
    fused_adam: bool = False
    # "exact" only: a fresh permutation per epoch ("affine" was a TPU
    # ablation and is not ported)
    shuffle: str = "exact"


# ------------------------------------------------------------------ network

def _orthogonal_linear(n_in: int, n_out: int, gain: float, generator) -> nn.Linear:
    layer = nn.Linear(n_in, n_out)
    with torch.no_grad():
        nn.init.orthogonal_(layer.weight, gain=gain, generator=generator)
        layer.bias.zero_()
    return layer


class ActorCritic(nn.Module):
    """Shared-nothing actor and critic MLPs (sb3 MlpPolicy shape): two tanh
    layers of `hidden` units per tower, a ``v_out`` head, and a ``pi_mean``
    head with a free ``log_std`` (continuous) or a ``pi_logits`` head.

    ``compute_dtype=torch.bfloat16`` computes the four hidden layers in
    bf16 (inputs, weights, bias add and tanh); the heads stay float32.
    """

    def __init__(self, obs_dim: int, action_dim: int, continuous: bool, hidden: int = 64,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.continuous = continuous
        self.compute_dtype = compute_dtype
        root2 = math.sqrt(2.0)
        self.pi_d1 = _orthogonal_linear(obs_dim, hidden, root2, generator)
        self.pi_d2 = _orthogonal_linear(hidden, hidden, root2, generator)
        self.v_d1 = _orthogonal_linear(obs_dim, hidden, root2, generator)
        self.v_d2 = _orthogonal_linear(hidden, hidden, root2, generator)
        self.v_out = _orthogonal_linear(hidden, 1, 1.0, generator)
        if continuous:
            self.pi_mean = _orthogonal_linear(hidden, action_dim, 0.01, generator)
            self.log_std = nn.Parameter(torch.zeros(action_dim))
        else:
            self.pi_logits = _orthogonal_linear(hidden, action_dim, 0.01, generator)

    def _dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        return x.to(cdt) @ layer.weight.to(cdt).T + layer.bias.to(cdt)

    def _tower(self, obs, d1, d2):
        return torch.tanh(self._dense(d2, torch.tanh(self._dense(d1, obs))))

    def forward(self, obs: torch.Tensor):
        pi = self._tower(obs, self.pi_d1, self.pi_d2).float()
        v = self._tower(obs, self.v_d1, self.v_d2).float()
        value = self.v_out(v)[..., 0]
        if self.continuous:
            return (self.pi_mean(pi), self.log_std), value
        return (self.pi_logits(pi),), value


# -------------------------------------------------------------------- dists

def _normal_logp(x, mean, log_std):
    var = torch.exp(2 * log_std)
    return torch.sum(-0.5 * ((x - mean) ** 2 / var + 2 * log_std + LOG_2PI), dim=-1)


def action_noise(shape, continuous: bool, generator: Optional[torch.Generator], dtype,
                 device) -> torch.Tensor:
    """The draws `sample_action` takes: N(0, 1) (Gaussian head) or Gumbel
    (categorical head, ``-log(-log(u))`` of uniforms) of `shape`."""
    if continuous:
        return torch.randn(shape, generator=generator, dtype=dtype, device=device)
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(dtype).tiny)))


def sample_action(dist, continuous: bool, noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None):
    """(action, logp). `noise` is N(0,1) shaped like the mean (Gaussian:
    ``mean + exp(log_std) * noise``) or Gumbel shaped like the logits
    (categorical: ``argmax(logits + noise)``); drawn from `generator` when
    not given."""
    if noise is None:
        noise = action_noise(dist[0].shape, continuous, generator, dist[0].dtype,
                             dist[0].device)
    if continuous:
        mean, log_std = dist
        action = mean + torch.exp(log_std) * noise
        return action, _normal_logp(action, mean, log_std)
    (logits,) = dist
    action = torch.argmax(logits + noise, dim=-1)
    logp = torch.log_softmax(logits, -1).gather(-1, action[..., None])[..., 0]
    return action, logp


def action_logp_entropy(dist, action, continuous: bool):
    if continuous:
        mean, log_std = dist
        logp = _normal_logp(action, mean, log_std)
        ent = torch.sum(log_std + 0.5 * LOG_2PI_E, dim=-1)
        return logp, ent.expand_as(logp)
    (logits,) = dist
    logps = torch.log_softmax(logits, -1)
    logp = logps.gather(-1, action.long()[..., None])[..., 0]
    ent = -torch.sum(torch.softmax(logits, -1) * logps, dim=-1)
    return logp, ent


# -------------------------------------------------------------------- state

@dataclasses.dataclass
class TrainState:
    """The network, Adam's moments (keyed by parameter name), the Adam
    update count and the number of optimizer steps taken."""

    model: ActorCritic
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    count: int = 0
    step: int = 0

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def clone(self) -> "TrainState":
        return copy.deepcopy(self)


def _continuous(env: Env) -> bool:
    return env.config.scheme == "continuous"


def make_train_state(env: Env, cfg: PPOConfig, generator: Optional[torch.Generator] = None,
                     device=None) -> TrainState:
    """A fresh network (orthogonal init from the CPU `generator`) on `device`
    (default: the card) with zero Adam moments."""
    device = resolve(device)
    continuous = _continuous(env)
    model = ActorCritic(
        obs_dim=env.observation_space.shape[0],
        action_dim=1 if continuous else env.config.n_actions,
        continuous=continuous,
        hidden=cfg.hidden,
        compute_dtype=getattr(torch, cfg.compute_dtype),
        generator=generator,
    ).to(device)
    zeros = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    return TrainState(model=model, m=zeros, v={n: z.clone() for n, z in zeros.items()})


def learning_rate(cfg: PPOConfig, count: int) -> float:
    """optax.linear_schedule(lr, 0, total_updates) at `count`, or the
    constant lr."""
    if not cfg.anneal_lr:
        return cfg.lr
    total = cfg.total_iterations * cfg.epochs * cfg.num_minibatches
    return cfg.lr * (1.0 - min(max(count, 0), total) / total)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Dict[str, torch.Tensor]:
    """optax.clip_by_global_norm: every gradient scaled by ``max_norm /
    norm`` only when ``norm >= max_norm``, with no host sync."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    keep = norm < max_norm
    return {name: torch.where(keep, g, g / norm * max_norm) for name, g in grads.items()}


def adam_step(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, lr: float,
              count1: int, eps: float = ADAM_EPS):
    """optax.adam's update of one parameter in place at the incremented count
    `count1`; returns the new moments (m, v)."""
    m = (1.0 - ADAM_B1) * g + ADAM_B1 * m
    v = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * v
    bc1 = 1.0 - ADAM_B1 ** count1
    bc2 = 1.0 - ADAM_B2 ** count1
    with torch.no_grad():
        p.add_((m / bc1) / (torch.sqrt(v / bc2) + eps) * (-lr))
    return m, v


def adam_apply(opt, params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
               lr: float, eps: float = ADAM_EPS) -> None:
    """One step of optax.adam(lr, eps) in place on `params` and on `opt`'s
    moments ``m``, ``v`` (keyed by parameter name) and host-int ``count``:
    the bias corrections use the incremented count."""
    count1 = opt.count + 1
    for name, p in params.items():
        opt.m[name], opt.v[name] = adam_step(p, grads[name], opt.m[name], opt.v[name], lr,
                                             count1, eps)
    opt.count = count1


def apply_gradients(ts: TrainState, grads: Dict[str, torch.Tensor], cfg: PPOConfig) -> None:
    """optax.chain(clip_by_global_norm(max_grad_norm), adam(lr, eps=ADAM_EPS))
    in place, lr from the schedule at the count before the step."""
    adam_apply(ts, dict(ts.model.named_parameters()),
               clip_by_global_norm(grads, cfg.max_grad_norm), learning_rate(cfg, ts.count))
    ts.step += 1


# ------------------------------------------------------------------ rollout

@dataclasses.dataclass(frozen=True)
class Transition:
    obs: Any
    action: Any
    logp: Any
    value: Any
    reward: Any
    done: Any
    episode_return: Any
    episode_length: Any


def collect_rollout(env: Env, env_params: EnvParams, cfg: PPOConfig, model: ActorCritic,
                    bstate: BatchState, generator: Optional[torch.Generator] = None,
                    act_noise: Optional[torch.Tensor] = None,
                    env_noise: Optional[torch.Tensor] = None,
                    mesh: Optional["Mesh"] = None):
    """`cfg.num_steps` steps of all envs under the current policy.

    Returns (bstate, obs_last, traj, last_value) with `traj` a time-major
    Transition. `act_noise` [T, B, A] and `env_noise` [T, 2, B] replace the
    generator's draws. With `mesh`, `bstate` holds the rank's envs of the
    global `cfg.num_envs`, and each step draws the global batch's noise and
    takes the rank's envs, as the single process would draw it (W times the
    draws, which costs nothing at these sizes)."""
    continuous = _continuous(env)
    obs = env.get_obs(env_params, bstate.env).float()
    envs = slice(None) if mesh is None else mesh.env_slice(cfg.num_envs)
    n_draw = bstate.episode_return.shape[0] if mesh is None else cfg.num_envs
    device = bstate.episode_return.device
    steps = []
    with torch.no_grad():
        for t in range(cfg.num_steps):
            dist, value = model(obs)
            a_noise = act_noise[t] if act_noise is not None else None
            if a_noise is None and mesh is not None:
                a_noise = action_noise((n_draw,) + tuple(dist[0].shape[1:]), continuous,
                                       generator, dist[0].dtype, device)[envs]
            action, logp = sample_action(dist, continuous, a_noise, generator)
            env_action = action if continuous else action.to(torch.int32)
            noise = generator if env_noise is None else env_noise[t]
            if env_noise is None and mesh is not None:
                noise = torch.randn((2, n_draw), generator=generator, dtype=env_params.dtype,
                                    device=device)[:, envs]
            bstate, rs = batched_step(env, env_params, bstate, env_action, noise)
            steps.append(Transition(
                obs=obs, action=action, logp=logp, value=value,
                reward=rs.reward.float(), done=rs.done,
                episode_return=rs.episode_return.float(), episode_length=rs.episode_length,
            ))
            obs = rs.obs.float()
        _, last_value = model(obs)
    traj = Transition(**{
        f.name: torch.stack([getattr(s, f.name) for s in steps])
        for f in dataclasses.fields(Transition)
    })
    return bstate, obs, traj, last_value


def compute_gae(cfg: PPOConfig, traj: Transition, last_value: torch.Tensor):
    """Reverse pass of GAE over the time axis -> (advantages, returns)."""
    gae = torch.zeros_like(last_value)
    next_value = last_value
    out = []
    for t in reversed(range(traj.reward.shape[0])):
        nonterminal = 1.0 - traj.done[t].float()
        delta = traj.reward[t] + cfg.gamma * next_value * nonterminal - traj.value[t]
        gae = delta + cfg.gamma * cfg.gae_lambda * nonterminal * gae
        out.append(gae)
        next_value = traj.value[t]
    advantages = torch.stack(out[::-1])
    return advantages, advantages + traj.value


# ------------------------------------------------------------------- update

def ppo_loss(model: ActorCritic, cfg: PPOConfig, batch, continuous: bool,
             adv_stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
             n: Optional[int] = None):
    """Clipped-PPO loss of one minibatch -> (total, metrics). The advantage
    normalisation uses the population std (``correction=0``), as jnp.std.

    A rank's share of a sharded minibatch passes the global minibatch's
    advantage (mean, std) as `adv_stats` and its size as `n`: every mean
    is then this rank's sum over `n`, and the ranks' losses add up to the
    global one."""
    obs, action, old_logp, old_value, adv, ret = batch
    dist, value = model(obs)
    logp, entropy = action_logp_entropy(dist, action, continuous)
    ratio = torch.exp(logp - old_logp)
    mean = (lambda x: x.mean()) if n is None else (lambda x: x.sum() / n)  # noqa: E731
    mu, std = (adv.mean(), adv.std(correction=0)) if adv_stats is None else adv_stats
    adv_n = (adv - mu) / (std + 1e-8)
    pg1 = ratio * adv_n
    pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n
    pg_loss = -mean(torch.minimum(pg1, pg2))
    v_clipped = old_value + torch.clamp(value - old_value, -cfg.clip_eps, cfg.clip_eps)
    v_loss = 0.5 * mean(torch.maximum((value - ret) ** 2, (v_clipped - ret) ** 2))
    ent = mean(entropy)
    total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
    approx_kl = mean((ratio - 1) - torch.log(ratio))
    return total, {"loss": total, "pg_loss": pg_loss, "v_loss": v_loss, "entropy": ent,
                   "approx_kl": approx_kl}


def _pack(traj: Transition, advantages, returns) -> torch.Tensor:
    """[T, B, ...] fields -> one [N, C] matrix (obs, action, logp, value,
    advantage, return); discrete actions ride as f32."""
    def fl2(x):
        x = x.reshape((-1,) + tuple(x.shape[2:]))
        return x[:, None] if x.dim() == 1 else x

    return torch.cat([fl2(traj.obs), fl2(traj.action.float()), fl2(traj.logp),
                      fl2(traj.value), fl2(advantages), fl2(returns)], dim=1)


def _stats_metrics(stats: torch.Tensor, n: int) -> Dict[str, torch.Tensor]:
    """The iteration's episode metrics from its sums over n samples:
    (n_done, sum of returns and of lengths at done, sum of rewards), as the
    fused rollout returns them."""
    n_done = stats[0]
    denom = torch.clamp(n_done, min=1.0)
    nan = torch.full_like(n_done, float("nan"))
    return {
        "episode_return": torch.where(n_done > 0, stats[1] / denom, nan),
        "episode_length": torch.where(n_done > 0, stats[2] / denom, nan),
        "mean_reward": stats[3] / n,
    }


def _episode_sums(traj: Transition) -> torch.Tensor:
    done_f = traj.done.float()
    return torch.stack([done_f.sum(), (traj.episode_return * done_f).sum(),
                        (traj.episode_length.float() * done_f).sum(), traj.reward.sum()])


def _episode_metrics(traj: Transition) -> Dict[str, torch.Tensor]:
    return _stats_metrics(_episode_sums(traj), traj.reward.numel())


def train_step(env: Env, env_params: EnvParams, cfg: PPOConfig, ts: TrainState,
               bstate: BatchState, generator: Optional[torch.Generator] = None,
               perms: Optional[Sequence[torch.Tensor]] = None,
               act_noise: Optional[torch.Tensor] = None,
               env_noise: Optional[torch.Tensor] = None,
               rollout_noise: Optional[torch.Tensor] = None,
               mesh: Optional["Mesh"] = None):
    """One PPO iteration (rollout + GAE + epochs of minibatch updates).

    Updates `ts` in place and returns (ts, bstate, metrics), the metrics as
    0-d tensors on the device (means over all minibatches, plus the
    iteration's episode statistics). `act_noise` and `env_noise` replace
    the plain rollout's draws, `rollout_noise` (planes of
    kernels/policy_rollout_kernel.py) the fused rollout's.

    With `mesh` (``shard.make_mesh``) the plain form computes the global
    step of `cfg.num_envs` envs, as JAX's jit of this function does on
    sharded inputs: `bstate` is the rank's share of the envs and `ts` a
    replica. Each rank steps its envs on the global batch's draws (see
    `collect_rollout`; injected `act_noise` and `env_noise` are the global
    ones), every rank draws the same global permutation of the
    ``T x num_envs`` samples and keeps the rows it owns, and each minibatch
    all-reduces its advantage sums, then its gradients and metrics (sums:
    the ranks' shares of a minibatch differ in size). Every rank then takes
    the same clip + Adam step. The fused forms take a mesh through
    ``shard.fused_ppo.make_sharded_fused_train_step``."""
    if mesh is not None and cfg.fused_update:
        raise NotImplementedError("train_step(mesh=) is the plain form; the fused forms shard "
                                  "through shard.fused_ppo.make_sharded_fused_train_step")
    if cfg.shuffle != "exact":
        raise NotImplementedError(f"shuffle={cfg.shuffle!r} is not ported; use 'exact'")
    if cfg.rollout_vector_gae:
        raise NotImplementedError("rollout_vector_gae is not ported; the GAE pass is sequential")
    continuous = _continuous(env)
    if perms is not None and len(perms) != cfg.epochs:
        raise ValueError(f"perms needs one permutation per epoch ({cfg.epochs})")

    if cfg.fused_update:
        from gym_fishing_tpu_torch.agents import ppo_fused

    # the two named ranges are what bench/profile.py reads from a trace
    if cfg.fused_rollout:
        if not cfg.fused_update:
            raise NotImplementedError("fused_rollout requires fused_update=True")
        if env.observation_space.shape != (1,):
            raise NotImplementedError("fused_rollout supports scalar observations only")
        if act_noise is not None or env_noise is not None:
            raise ValueError("the fused rollout takes its draws as rollout_noise planes")
        with torch.profiler.record_function("train_step/rollout"):
            roll, bstate = ppo_fused.fused_rollout_collect(env, env_params, cfg, ts, bstate,
                                                           generator, rollout_noise)
        packed_t, traj = roll.packed_t, None
        obs_dim = act_dim = 1
    else:
        if rollout_noise is not None:
            raise ValueError("rollout_noise is the fused rollout's; use act_noise, env_noise")
        if mesh is not None:
            envs = mesh.env_slice(cfg.num_envs)
            if bstate.episode_return.shape[0] != envs.stop - envs.start:
                raise ValueError(f"bstate holds {bstate.episode_return.shape[0]} envs, not the "
                                 f"rank's {envs.stop - envs.start} of {cfg.num_envs}")
            act_noise = None if act_noise is None else act_noise[:, envs]
            env_noise = None if env_noise is None else env_noise[:, :, envs]
        with torch.profiler.record_function("train_step/rollout"):
            bstate, _, traj, last_value = collect_rollout(env, env_params, cfg, ts.model,
                                                          bstate, generator, act_noise,
                                                          env_noise, mesh)
            advantages, returns = compute_gae(cfg, traj, last_value)
            packed = _pack(traj, advantages, returns)
        obs_dim = traj.obs.shape[-1]
        act_dim = packed.shape[1] - obs_dim - 4

    with torch.profiler.record_function("train_step/update"):
        if cfg.fused_update:
            head = "gaussian" if continuous else "categorical"
            kern_act_dim = act_dim if continuous else env.config.n_actions
            if traj is not None:
                packed_t = ppo_fused.pack_feature_major(packed)
            scan = (ppo_fused.fused_epoch_scan_adam if cfg.fused_adam
                    else ppo_fused.fused_epoch_scan)
            metrics = scan(cfg, ts, packed_t, obs_dim, kern_act_dim, generator, head=head,
                           perms=perms)
        else:
            metrics = _plain_epochs(cfg, ts, packed, obs_dim, act_dim, continuous, generator,
                                    perms, mesh)
    metrics = {k: v.mean() for k, v in metrics.items()}
    if traj is None:
        metrics.update(_stats_metrics(roll.stats, cfg.num_steps * cfg.num_envs))
    elif mesh is None:
        metrics.update(_episode_metrics(traj))
    else:
        metrics.update(_stats_metrics(mesh.all_reduce(_episode_sums(traj)),
                                      cfg.num_steps * cfg.num_envs))
    return ts, bstate, metrics


def _owned_rows(perm: torch.Tensor, mesh: "Mesh", num_envs: int) -> torch.Tensor:
    """The rank's local rows among the global sample indices `perm`, in
    their order: global row ``t N + b`` (t-major) belongs to the rank that
    owns env b, where it is row ``t n + b - r n``."""
    n_local = num_envs // mesh.world
    t, b = perm // num_envs, perm % num_envs
    own = b // n_local == mesh.rank
    return t[own] * n_local + (b[own] - mesh.rank * n_local)


def _plain_epochs(cfg, ts, packed, obs_dim, act_dim, continuous, generator, perms, mesh=None):
    world = 1 if mesh is None else mesh.world
    n = packed.shape[0] * world
    mb_size = n // cfg.num_minibatches
    names = [name for name, _ in ts.model.named_parameters()]
    history = []
    for e in range(cfg.epochs):
        perm = perms[e] if perms is not None else torch.randperm(
            n, generator=generator, device=packed.device)
        perm = perm.to(packed.device).long()
        shuffled = packed[perm] if mesh is None else None
        for i in range(cfg.num_minibatches):
            if mesh is None:
                mb = shuffled[i * mb_size:(i + 1) * mb_size]
            else:
                mb = packed[_owned_rows(perm[i * mb_size:(i + 1) * mb_size], mesh,
                                        cfg.num_envs)]
            action = mb[:, obs_dim:obs_dim + act_dim]
            if not continuous:
                action = action[:, 0].to(torch.int32)
            rest = mb[:, obs_dim + act_dim:]
            batch = (mb[:, :obs_dim], action, rest[:, 0], rest[:, 1], rest[:, 2], rest[:, 3])
            if mesh is None:
                loss, mets = ppo_loss(ts.model, cfg, batch, continuous)
                grads = torch.autograd.grad(loss, list(ts.model.parameters()))
            else:
                adv = rest[:, 2]
                s = mesh.all_reduce(torch.stack([adv.sum(), (adv * adv).sum()]).detach())
                mu = s[0] / mb_size
                std = torch.sqrt(torch.clamp(s[1] / mb_size - mu * mu, min=0.0))
                loss, mets = ppo_loss(ts.model, cfg, batch, continuous, (mu, std), mb_size)
                grads = torch.autograd.grad(loss, list(ts.model.parameters()))
                grads, mets = all_reduce_flat(mesh, grads, mets)
            apply_gradients(ts, dict(zip(names, grads)), cfg)
            history.append({k: v.detach() for k, v in mets.items()})
    return {k: torch.stack([h[k] for h in history]) for k in history[0]}


def all_reduce_flat(mesh: "Mesh", grads: Sequence[torch.Tensor],
                    metrics: Mapping[str, torch.Tensor]):
    """Gradients and metrics summed over the ranks in one collective on one
    flat buffer -> (grads as a list, metrics as a dict)."""
    names = list(metrics)
    flat = torch.cat([g.detach().reshape(-1) for g in grads]
                     + [torch.stack([metrics[k].detach() for k in names])])
    flat = mesh.all_reduce(flat)
    parts = torch.split(flat, [g.numel() for g in grads] + [len(names)])
    return ([p.reshape(g.shape) for p, g in zip(parts, grads)],
            dict(zip(names, parts[-1].unbind())))


def train(env: Env, cfg: PPOConfig, seed: int = 0, iterations: int = 32,
          env_params: Optional[EnvParams] = None, verbose: bool = False, device=None):
    """Host loop over `train_step` on `device` (default: the card). The
    network is initialised from a CPU generator seeded with `seed`; the
    rollout and the shuffles draw from a generator on `device` seeded with
    `seed` + 1. Returns (ts, history of float metrics per iteration)."""
    device = resolve(device)
    if env_params is None:
        # the fused rollout reads the env params on the host, where they
        # cost no sync; the plain rollout steps with them on the device
        env_params = env.params(device="cpu" if cfg.fused_rollout else device)
    ts = make_train_state(env, cfg, torch.Generator().manual_seed(seed), device)
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    bstate = batched_reset(env, env_params, cfg.num_envs, device)
    history = []
    for it in range(iterations):
        ts, bstate, metrics = train_step(env, env_params, cfg, ts, bstate, generator)
        history.append({k: float(v) for k, v in metrics.items()})
        if verbose:
            print(f"iter {it}: {history[-1]}")
    return ts, history


class PPOPolicy:
    """sb3-style `.predict` wrapper over a trained TrainState: the mean
    action (continuous) or the argmax class (discrete)."""

    def __init__(self, env: Env, ts: TrainState):
        self.env = env
        self.ts = ts
        self.continuous = _continuous(env)

    def act(self, obs, carried_harvest=None):
        with torch.no_grad():
            dist, _ = self.ts.model(obs.float())
        if self.continuous:
            return dist[0]
        return torch.argmax(dist[0], dim=-1).to(torch.int32)

    def predict(self, obs, state=None, episode_start=None, deterministic=True):
        device = next(self.ts.model.parameters()).device
        a = self.act(torch.as_tensor(np.asarray(obs), device=device))
        return a.cpu().numpy(), state
