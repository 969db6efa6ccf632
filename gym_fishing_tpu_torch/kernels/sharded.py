"""K1 on every rank: the fused rollout kernel over a sharded batch.

Counterpart of ``gym_fishing_tpu/kernels/sharded.py``. Env shards never
communicate, so each rank (one process per device, see `shard.mesh`) runs
the fused rollout kernel on its own envs. The rank is folded into the
64-bit Philox key (`shard.fold_rank`; rank 0's fold is the identity, so one
rank reproduces the single-device stream): without it every rank would
replay the same noise, since the kernel's counter is the env's index within
its call. A launcher, not a kernel: `kernels.rollout_kernel.rollout` is the
kernel's wrapper and counts its launches.
"""

from __future__ import annotations

import torch

from gym_fishing_tpu_torch.core.types import EnvParams
from gym_fishing_tpu_torch.kernels.rollout_kernel import KernelRollout, rollout
from gym_fishing_tpu_torch.shard.mesh import Mesh, fold_rank


def sharded_rollout(mesh: Mesh, stock: torch.Tensor, t: torch.Tensor, params: EnvParams,
                    policy: str, policy_param, num_steps: int, *, seed: int = 0,
                    **kernel_kw) -> KernelRollout:
    """`rollout` of the rank's envs (`stock`, `t`: its slice, e.g. from
    ``shard.shard_batch``) with the rank's key ``fold_rank(seed, rank)``.
    Every rank passes the same `seed` and, when chaining, the same offset
    (`next_offset` advances alike on every rank)."""
    return rollout(stock, t, params, policy, policy_param, num_steps,
                   seed=fold_rank(seed, mesh.rank), **kernel_kw)
