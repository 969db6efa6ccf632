"""Start W ranks on this machine and collect what each returns.

`spawn_ranks` runs ``target(mesh, job)`` in W child processes joined by a
``file://`` rendezvous in a fresh temporary directory (no port to collide
on), one CPU thread each, and returns the W results. The job goes to the
children and the results come back through files (``torch.save``); a child
that exits non-zero, outlives the timeout or leaves no result fails the
call, and every child is stopped and the directory removed before it
returns or raises. A child imports only the target's module (found on the
working directory, the repository's root or PYTHONPATH), never the
caller's.

`train_job` and `rollout_job` are targets that drive the sharded paths
from a job (a dict): the PPO step in its plain form
(``agents.ppo.train_step(mesh=)``) or the fused one
(``shard.fused_ppo.make_sharded_fused_train_step``), and K1 through
``kernels.sharded.sharded_rollout``. Global batches and noise planes in a
job are cut into the ranks' slices here.

    python -m gym_fishing_tpu_torch.shard.launch DIR RANK

is a child's command line (its spec and job lie in DIR).
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Optional

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def spawn_ranks(target: str, world: int, job: Any = None, *, device="cpu",
                backend: Optional[str] = None, timeout_s: float = 120.0) -> list:
    """``target`` ("module:function") run by `world` ranks -> their results,
    by rank. `device` is every rank's device ("cpu", "cuda:0", ...), or None
    for ``cuda:r`` in rank r; `backend` defaults to NCCL on the card and
    gloo on the CPU."""
    work = tempfile.mkdtemp(prefix="ranks-")
    try:
        return _run(work, target, world, job, device, backend, timeout_s)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(work, target, world, job, device, backend, timeout_s) -> list:
    spec = {"target": target, "world": world, "device": None if device is None else str(device),
            "backend": backend, "timeout_s": timeout_s}
    with open(os.path.join(work, "spec.json"), "w") as f:
        json.dump(spec, f)
    torch.save(job, os.path.join(work, "job.pt"))
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (os.getcwd(), _ROOT, env.get("PYTHONPATH"))
                                        if p)
    procs = []
    try:
        for rank in range(world):
            log = open(os.path.join(work, f"rank{rank}.log"), "w")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "gym_fishing_tpu_torch.shard.launch", work, str(rank)],
                stdout=log, stderr=subprocess.STDOUT, env=dict(env, LOCAL_RANK=str(rank))))
            log.close()
        deadline = time.monotonic() + timeout_s
        for rank, p in enumerate(procs):
            try:
                rc = p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank {rank} of {target} did not finish in {timeout_s} s"
                                   f"\n{_tail(work, rank)}") from None
            if rc != 0:
                raise RuntimeError(f"rank {rank} of {target} exited {rc}\n{_tail(work, rank)}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank in range(world):
        path = os.path.join(work, f"result{rank}.pt")
        if not os.path.exists(path):
            raise RuntimeError(f"rank {rank} of {target} left no result\n{_tail(work, rank)}")
        results.append(torch.load(path, weights_only=False))
    return results


def _tail(work: str, rank: int, n: int = 4000) -> str:
    try:
        with open(os.path.join(work, f"rank{rank}.log")) as f:
            return f.read()[-n:]
    except OSError:
        return ""


def _child(work: str, rank: int) -> None:
    import torch.distributed as dist

    from gym_fishing_tpu_torch.shard.mesh import distributed_init, make_mesh

    torch.set_num_threads(1)
    with open(os.path.join(work, "spec.json")) as f:
        spec = json.load(f)
    job = torch.load(os.path.join(work, "job.pt"), weights_only=False)
    module, name = spec["target"].split(":")
    fn = getattr(importlib.import_module(module), name)
    distributed_init(f"file://{os.path.join(work, 'rendezvous')}", spec["world"], rank,
                     backend=spec["backend"], device=spec["device"],
                     timeout_s=spec["timeout_s"])
    try:
        result = fn(make_mesh(device=spec["device"]), job)
    finally:
        dist.destroy_process_group()
    tmp = os.path.join(work, f"result{rank}.pt.tmp")
    torch.save(result, tmp)
    os.replace(tmp, os.path.join(work, f"result{rank}.pt"))


# ------------------------------------------------------------------ targets

def _launch_counts() -> dict:
    from gym_fishing_tpu_torch.kernels import policy_rollout_kernel as pk
    from gym_fishing_tpu_torch.kernels import ppo_update_kernel as uk
    from gym_fishing_tpu_torch.kernels import rollout_kernel as rk

    return {"rollout": rk.launches, "grad": uk.grad_launches, "adam": uk.adam_launches,
            "policy": pk.launches}


def _cpu(tree):
    from gym_fishing_tpu_torch.core.tree import tree_map

    return tree_map(lambda x: x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor)
                    else x, tree)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_job(mesh, job: dict) -> dict:
    """`job["iterations"]` sharded PPO steps of the rank, in ``job["form"]``
    "plain" (``train_step(mesh=)``) or "fused" (the sharded fused step).

    The job gives ``env_id`` and ``env_kw``, ``cfg`` (PPOConfig's fields,
    ``num_envs`` global), the start ``state`` (a TrainState; else one made
    from ``init_seed``), which rank 0 broadcasts, and the global ``bstate``
    (else each rank resets its own envs); the generator on the rank's device
    is seeded with ``seed``. Per iteration it may inject ``perms`` and the
    global ``rollout_noise`` (fused) or ``act_noise``/``env_noise`` (plain).
    Returns the replica's parameters, moments and counts, the metrics and
    host milliseconds of each iteration, the rank's envs, the checksums of
    the parameters and of the global env state, and the kernel launches."""
    from gym_fishing_tpu_torch.agents import ppo
    from gym_fishing_tpu_torch.batch import batched_reset
    from gym_fishing_tpu_torch.registry import make
    from gym_fishing_tpu_torch.shard.fused_ppo import make_sharded_fused_train_step
    from gym_fishing_tpu_torch.shard.mesh import (
        host_local_to_global,
        replicate,
        shard_batch,
        state_checksum,
    )

    dev = mesh.device
    cfg = ppo.PPOConfig(**job["cfg"])
    fused = job["form"] == "fused"
    env, params = make(job["env_id"], device="cpu" if fused else dev, **job.get("env_kw", {}))
    if job.get("state") is not None:
        ts = job["state"].clone()
        ts.model.to(dev)
        ts.m = {k: v.to(dev) for k, v in ts.m.items()}
        ts.v = {k: v.to(dev) for k, v in ts.v.items()}
    else:
        ts = ppo.make_train_state(env, cfg, torch.Generator().manual_seed(job.get("init_seed", 0)),
                                  dev)
    replicate(ts, mesh)
    if job.get("bstate") is not None:
        bstate = shard_batch(job["bstate"], mesh)
    else:
        bstate = batched_reset(env, params, cfg.num_envs // mesh.world, dev)
    bstate = host_local_to_global(bstate, mesh)
    envs = mesh.env_slice(cfg.num_envs)
    generator = torch.Generator(device=dev).manual_seed(job.get("seed", 0))
    step = make_sharded_fused_train_step(env, params, cfg, mesh) if fused else None
    metrics, ms = [], []
    start = _launch_counts()
    for it in range(job["iterations"]):
        inject = lambda key: (job[key][it] if job.get(key) is not None else None)  # noqa: E731
        perms = inject("perms")
        _sync(dev)
        t0 = time.perf_counter()
        if fused:
            noise = inject("rollout_noise")
            noise = None if noise is None else noise[..., envs].to(dev).contiguous()
            ts, bstate, met = step(ts, bstate, generator, perms=perms, rollout_noise=noise)
        else:
            act, env_n = inject("act_noise"), inject("env_noise")
            ts, bstate, met = ppo.train_step(
                env, params, cfg, ts, bstate, generator, perms=perms,
                act_noise=None if act is None else act.to(dev),
                env_noise=None if env_n is None else env_n.to(dev), mesh=mesh)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in met.items()})
    end = _launch_counts()
    return {
        "rank": mesh.rank,
        "params": _cpu(dict(ts.params())),
        "m": _cpu(ts.m),
        "v": _cpu(ts.v),
        "count": ts.count,
        "step": ts.step,
        "metrics": metrics,
        "ms": ms,
        "bstate": _cpu(bstate),
        "checksum": float(state_checksum(ts.model, mesh)),
        "bstate_checksum": float(state_checksum(bstate, mesh)),
        "launches": {k: end[k] - start[k] for k in end},
    }


def rollout_job(mesh, job: dict) -> dict:
    """K1 on the rank's slice of the global ``stock`` and ``t`` through
    `sharded_rollout`, with ``env_id``/``env_kw``'s params (on the host),
    ``policy``, ``policy_param``, ``num_steps``, ``seed`` and ``kernel_kw``
    (a global ``noise`` plane is cut to the rank's envs). Returns the
    rank's KernelRollout fields and the launches."""
    from gym_fishing_tpu_torch.kernels.sharded import sharded_rollout
    from gym_fishing_tpu_torch.registry import make
    from gym_fishing_tpu_torch.shard.mesh import shard_batch

    _, params = make(job["env_id"], device="cpu", **job.get("env_kw", {}))
    stock, t = shard_batch((job["stock"], job["t"]), mesh)
    kw = dict(job.get("kernel_kw", {}))
    if kw.get("noise") is not None:
        kw["noise"] = kw["noise"][..., mesh.env_slice(job["stock"].shape[0])].to(
            mesh.device).contiguous()
    start = _launch_counts()
    out = sharded_rollout(mesh, stock, t, params, job["policy"], job["policy_param"],
                          job["num_steps"], seed=job.get("seed", 0), **kw)
    _sync(mesh.device)
    end = _launch_counts()
    return {"rank": mesh.rank, "out": _cpu(out._asdict()),
            "launches": {k: end[k] - start[k] for k in end}}


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]))
