"""The multi-device path: one process per device over `torch.distributed`.

Counterpart of ``gym_fishing_tpu/shard``: the mesh helpers
(`shard.mesh`) and the sharded fused PPO step (`shard.fused_ppo`). The plain
PPO step takes the mesh itself (``agents.ppo.train_step(..., mesh=)``), K1's
launcher is ``kernels.sharded.sharded_rollout``.
"""

from gym_fishing_tpu_torch.shard.mesh import (
    ENVS_AXIS,
    Mesh,
    distributed_init,
    fold_rank,
    host_local_to_global,
    is_distributed_initialized,
    local_device,
    make_mesh,
    replicate,
    shard_batch,
    state_checksum,
)

__all__ = [
    "ENVS_AXIS",
    "Mesh",
    "distributed_init",
    "fold_rank",
    "host_local_to_global",
    "is_distributed_initialized",
    "local_device",
    "make_mesh",
    "replicate",
    "shard_batch",
    "state_checksum",
]
