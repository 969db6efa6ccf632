"""Multi-process PPO training, one process per GPU: the port of
``examples/multihost_train.py``.

Start one copy per GPU, through torchrun on each host:

    torchrun --nnodes N --nproc-per-node GPUS --rdzv-backend c10d \
        --rdzv-endpoint HOST0:29500 -m gym_fishing_tpu_torch.examples.multihost_train

or by hand with ``--coordinator HOST0:PORT --num-processes W --process-id R``
(also a ``file://`` URL). Every rank runs the same program on
``cuda:LOCAL_RANK``: it holds `--num-envs-per-chip` envs and a replica of
the learner, and the plain PPO step all-reduces each minibatch's gradients
(``agents.ppo.train_step(..., mesh=)``). Without a coordinator it is a
single process on one device. Rank 0 prints every 10 iterations.
"""

from __future__ import annotations

import argparse
from typing import List


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num-envs-per-chip", type=int, default=4096)
    ap.add_argument("--num-steps", type=int, default=128)
    ap.add_argument("--iterations", type=int, default=50)
    ap.add_argument("--coordinator", default=None,
                    help="host:port (or an init-method URL) of rank 0; torchrun's "
                    "MASTER_ADDR/MASTER_PORT otherwise")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="this rank's device (default: the card cuda:LOCAL_RANK)")
    args = ap.parse_args(argv)

    import torch

    from gym_fishing_tpu_torch.agents.ppo import PPOConfig, make_train_state, train_step
    from gym_fishing_tpu_torch.batch import batched_reset
    from gym_fishing_tpu_torch.registry import make
    from gym_fishing_tpu_torch.shard import (
        distributed_init,
        host_local_to_global,
        make_mesh,
        replicate,
    )

    distributed_init(args.coordinator, args.num_processes, args.process_id, device=args.device)
    mesh = make_mesh(device=args.device)
    env, params = make("fishing-v1", sigma=0.05, device=mesh.device)
    cfg = PPOConfig(num_envs=args.num_envs_per_chip * mesh.world, num_steps=args.num_steps)
    # rank 0's initial weights on every rank; each rank resets only its own envs
    ts = replicate(make_train_state(env, cfg, torch.Generator().manual_seed(0), mesh.device),
                   mesh)
    bstate = host_local_to_global(
        batched_reset(env, params, args.num_envs_per_chip, mesh.device), mesh)
    # the same seed on every rank: the ranks draw in lockstep
    generator = torch.Generator(device=mesh.device).manual_seed(1)
    history = []
    for it in range(args.iterations):
        ts, bstate, metrics = train_step(env, params, cfg, ts, bstate, generator, mesh=mesh)
        history.append({k: float(v) for k, v in metrics.items()})
        if mesh.rank == 0 and it % 10 == 0:
            print(f"iter {it}: ep_ret={history[-1]['episode_return']:.5f} "
                  f"({mesh.world} ranks, {cfg.num_envs} envs)", flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return history


if __name__ == "__main__":
    main()
