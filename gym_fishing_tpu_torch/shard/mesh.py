"""One process per device: the rank's mesh, and the helpers that place a
batch and a learner on it.

Counterpart of ``gym_fishing_tpu/shard/mesh.py``. JAX runs one program over
a mesh of devices and lets GSPMD partition each global array; here each
device is driven by a process of its own (a "rank") in a
`torch.distributed` process group. A rank holds its slice of the envs and a
whole copy of the learner, and every cross-rank reduction is an explicit
collective on the mesh (`Mesh.all_reduce`, `Mesh.broadcast`). Only those two
collectives are used: gloo takes them on CUDA tensors, NCCL on nothing else.

JAX's ``env_sharding``, ``replicated`` and ``constrain_envs`` are XLA
sharding annotations: with each rank holding its own slice there is nothing
for them to annotate, and they are not ported.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Iterator, Optional

import torch
import torch.distributed as dist
from torch import nn

from gym_fishing_tpu_torch.core.tree import tree_map
from gym_fishing_tpu_torch.device import resolve

ENVS_AXIS = "envs"
_U64 = 1 << 64
_FOLD = 0x9E3779B97F4A7C15   # odd: distinct ranks give distinct keys


def is_distributed_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def local_device(device=None) -> torch.device:
    """The rank's device: `device`, or the card numbered by torchrun's
    ``LOCAL_RANK`` (0 without it). Raises where there is no card, as
    `device.resolve` does."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    return resolve(device)


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, backend: Optional[str] = None,
                     device=None, timeout_s: float = 300.0) -> None:
    """Join the process group once per process, before any collective.

    The coordinator is ``coordinator_address`` ("host:port", or an
    init-method URL such as ``file:///path``) with `num_processes` and
    `process_id`, or else torchrun's ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``. Without a coordinator this is a no-op (a
    single process), as is a second call. The backend is NCCL on the card
    and gloo on the CPU unless `backend` says otherwise; the card is the
    default `device` (`local_device`), and a machine without one raises
    rather than joining on the CPU. A failed rendezvous raises.
    """
    if is_distributed_initialized():
        return
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if coordinator_address is None:
        return
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env["RANK"])
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dev = local_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=coordinator_address, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The 1-D mesh over the group's ranks (its one dimension is
    `ENVS_AXIS`), seen from one rank: its index, the world size, its device
    and the process group (None for a mesh of one rank without a group,
    whose collectives are the identity)."""

    rank: int
    world: int
    device: torch.device
    group: Any = None

    def env_slice(self, num_envs: int) -> slice:
        """The rank's envs ``[r n, (r + 1) n)`` of `num_envs`, n = num_envs / world."""
        if num_envs % self.world:
            raise ValueError(f"num_envs {num_envs} not divisible by mesh axis {self.world}")
        n = num_envs // self.world
        return slice(self.rank * n, (self.rank + 1) * n)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """`x` reduced over the ranks (in place), "sum" or "max"."""
        if self.group is not None:
            ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
            dist.all_reduce(x, op=ops[op], group=self.group)
        return x

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """`x` overwritten with rank 0's (in place)."""
        if self.group is not None:
            dist.broadcast(x, src=0, group=self.group)
        return x


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh over the process group's ranks (one device each), or a mesh
    of one rank when no group has been joined. `n_devices`, when given,
    must be the world size; `device` is the rank's (default
    `local_device`)."""
    dev = local_device(device)
    if not is_distributed_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} devices needs one process each: call "
                             "distributed_init in every rank first")
        return Mesh(0, 1, dev)
    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise ValueError(f"n_devices {n_devices} is not the world size {world}")
    return Mesh(dist.get_rank(), world, dev, dist.group.WORLD)


def fold_rank(seed: int, rank: int) -> int:
    """A 64-bit Philox key for `rank` from the shared `seed`; rank 0's is
    `seed` itself, so one rank reproduces the single-device stream."""
    return (seed + rank * _FOLD) % _U64


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    """Every tensor of `tree`: a module's parameters and buffers, a
    dataclass's fields, a dict's values, a sequence's items."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from (p.data for p in tree.parameters())
        yield from tree.buffers()
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def shard_batch(tree: Any, mesh: Mesh) -> Any:
    """The rank's slice of a globally sized batch tree (leading dimension
    = envs), on the rank's device."""
    def take(x):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        return x[mesh.env_slice(x.shape[0])].to(mesh.device).contiguous()

    return tree_map(take, tree)


def host_local_to_global(tree: Any, mesh: Mesh) -> Any:
    """The rank's own slice, as it is, once every rank is known to hold the
    same number of envs (one all-reduce of the leading sizes)."""
    sizes = {int(x.shape[0]) for x in _tensors(tree) if x.dim() > 0}
    if len(sizes) > 1:
        raise ValueError(f"the leaves' leading sizes differ: {sorted(sizes)}")
    n = sizes.pop() if sizes else 0
    both = mesh.all_reduce(torch.tensor([n, -n], dtype=torch.int64, device=mesh.device), "max")
    hi, lo = int(both[0]), -int(both[1])
    if hi != lo:
        raise ValueError(f"the ranks hold between {lo} and {hi} envs; every rank must hold "
                         "the same share")
    return tree


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Rank 0's values of every tensor of `tree` (a TrainState, a module,
    a dict ...) on every rank, in place; returns `tree`."""
    for x in _tensors(tree):
        mesh.broadcast(x)
    return tree


def state_checksum(tree: Any, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The float64 sum of every floating tensor of `tree`, a divergence
    check. With `mesh` the ranks' sums are added, so a batch sharded over
    the mesh gives the checksum of the global batch."""
    leaves = [x.detach().double().sum() for x in _tensors(tree) if x.is_floating_point()]
    device = mesh.device if mesh is not None else (leaves[0].device if leaves else "cpu")
    total = torch.stack([x.to(device) for x in leaves]).sum() if leaves else torch.zeros(
        (), dtype=torch.float64, device=device)
    return mesh.all_reduce(total) if mesh is not None else total
