"""The sharded fused PPO step: K4 and K2 on every rank, the gradients
all-reduced.

Counterpart of ``gym_fishing_tpu/shard/fused_ppo.py``, whose shard_map runs
the fused kernels on each device's shard. Here each rank is a process (see
`shard.mesh`):

- the rank runs the policy-rollout kernel K4 on its envs, with its rank
  folded into the Philox seed (`shard.fold_rank`; rank 0's fold is the
  identity), so the ranks draw independent streams;
- each minibatch is the union of the ranks' tile sets: every rank permutes
  its own tiles with the same permutation, all-reduces the advantage sums,
  runs K2 on its tiles and all-reduces the gradients and metrics in one
  buffer (`agents.ppo_fused.fused_epoch_scan(mesh=)`), and all ranks take the
  identical clip + Adam step, which keeps the replicas equal.

At one rank (NCCL at world size 1) the step is the single-device ``full``
form's, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from gym_fishing_tpu_torch.agents import ppo_fused
from gym_fishing_tpu_torch.agents.ppo import PPOConfig, _stats_metrics
from gym_fishing_tpu_torch.core.env import Env
from gym_fishing_tpu_torch.core.types import EnvParams
from gym_fishing_tpu_torch.shard.mesh import Mesh


def make_sharded_fused_train_step(env: Env, env_params: EnvParams, cfg: PPOConfig, mesh: Mesh):
    """A callable ``(ts, bstate, generator, *, perms=None, rollout_noise=None)
    -> (ts, bstate, metrics)`` for one rank of `mesh`.

    `cfg.num_envs` is the global env count; `bstate` holds the rank's
    ``num_envs / world`` envs (``shard.shard_batch`` or its own reset), `ts`
    a replica (``shard.replicate``). Every rank passes a generator in the
    same state: it gives K4's seed and offset (the seed folded with the
    rank) and the tile permutations. `rollout_noise` replaces K4's draws with
    the rank's own planes, `perms` the permutations of the rank's tiles.
    The metrics are the global step's on every rank.

    ``cfg.fused_adam`` is ignored, as JAX's sharded path ignores it: the
    in-kernel optimizer (K3) would step before the gradients are reduced.
    The fused rollout's requirements hold (scalar observations, host
    `env_params` with a scalar sigma_m). Raises NotImplementedError without
    ``cfg.fused_update`` and ValueError when the ranks cannot share the envs
    equally.
    """
    if not cfg.fused_update:
        raise NotImplementedError(
            "make_sharded_fused_train_step is the fused-kernel composition; the plain form "
            "takes the mesh in agents.ppo.train_step(..., mesh=)")
    if cfg.num_envs % mesh.world:
        raise ValueError(f"num_envs {cfg.num_envs} not divisible by mesh axis {mesh.world}")
    if env.observation_space.shape != (1,):
        raise NotImplementedError("the fused rollout supports scalar observations only")
    if cfg.shuffle != "exact" or cfg.rollout_vector_gae:
        raise NotImplementedError("shuffle='affine' and rollout_vector_gae are not ported")
    local_cfg = dataclasses.replace(cfg, num_envs=cfg.num_envs // mesh.world)
    continuous = env.config.scheme == "continuous"
    head = "gaussian" if continuous else "categorical"
    kern_act_dim = 1 if continuous else env.config.n_actions

    def step(ts, bstate, generator: Optional[torch.Generator] = None, *,
             perms: Optional[Sequence[torch.Tensor]] = None,
             rollout_noise: Optional[torch.Tensor] = None):
        if bstate.episode_return.shape[0] != local_cfg.num_envs:
            raise ValueError(f"bstate holds {bstate.episode_return.shape[0]} envs, not the "
                             f"rank's {local_cfg.num_envs} of {cfg.num_envs}")
        with torch.profiler.record_function("train_step/rollout"):
            roll, bstate = ppo_fused.fused_rollout_collect(
                env, env_params, local_cfg, ts, bstate, generator, rollout_noise, mesh.rank)
        with torch.profiler.record_function("train_step/update"):
            metrics = ppo_fused.fused_epoch_scan(local_cfg, ts, roll.packed_t, 1, kern_act_dim,
                                                 generator, head=head, perms=perms, mesh=mesh)
        metrics = {k: v.mean() for k, v in metrics.items()}
        stats = mesh.all_reduce(roll.stats.clone())
        metrics.update(_stats_metrics(stats, cfg.num_envs * cfg.num_steps))
        return ts, bstate, metrics

    return step
