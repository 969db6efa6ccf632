"""The port's mesh helpers (gym_fishing_tpu_torch/shard/mesh.py) and the
plain PPO step under a mesh (``agents.ppo.train_step(..., mesh=)``), on the
CPU with two gloo ranks.

One job of two ranks (``shard.launch.spawn_ranks``, a ``file://``
rendezvous, one thread each) runs once for the module; the tests assert on
what it returns:

- the helpers: `shard_batch` gives each rank its envs, `host_local_to_global`
  accepts equal shares and refuses unequal ones on every rank, `replicate`
  makes rank 0's weights everyone's, `state_checksum` of a sharded batch is
  the single process's checksum of the global batch;
- the plain step at 64 envs x 16 steps, 2 epochs x 2 minibatches
  (tests/test_shard.py:48-65's configuration), from weights converted from
  the flax tree and JAX's own draws and permutations (the key schedule of
  tests/test_torch_ppo.py), against JAX's ``train_step`` jitted on a
  2-device mesh (GSPMD's global step) and against the port's
  single-process step, at tests/test_shard.py's atol 1e-5; the two ranks'
  replicas are bit-identical.

The rank body below imports no JAX: the JAX side runs in the test process.
"""

import functools
import os

import numpy as np
import pytest
import torch

import gym_fishing_tpu_torch as gtt
from gym_fishing_tpu_torch.agents import ppo
from gym_fishing_tpu_torch.batch import BatchState, batched_reset
from gym_fishing_tpu_torch.core.types import EnvState
from gym_fishing_tpu_torch.shard import (
    Mesh,
    distributed_init,
    fold_rank,
    make_mesh,
    shard_batch,
    state_checksum,
)
from gym_fishing_tpu_torch.shard.launch import spawn_ranks

make = functools.partial(gtt.make, device="cpu")

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
CFG = dict(num_envs=64, num_steps=16, epochs=2, num_minibatches=2)


def _global_bstate(n=8):
    return BatchState(
        env=EnvState(stock=torch.linspace(0.1, 0.8, n), harvest=torch.arange(n) * 0.01,
                     t=torch.arange(n, dtype=torch.int32)),
        episode_return=torch.arange(n, dtype=torch.float32) * 0.5,
        episode_length=torch.arange(n, dtype=torch.int32))


def rank_body(mesh, job):
    """The helpers' checks in each rank, then the plain step's job."""
    from gym_fishing_tpu_torch.shard import host_local_to_global, replicate
    from gym_fishing_tpu_torch.shard.launch import train_job

    out = {"rank": mesh.rank, "world": mesh.world}
    glob = _global_bstate()
    local = shard_batch(glob, mesh)
    out["local_stock"] = local.env.stock
    out["local_t"] = local.env.t
    host_local_to_global(local, mesh)
    uneven = shard_batch(_global_bstate(8 + 2 * mesh.rank), mesh)
    try:
        host_local_to_global(uneven, mesh)
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)
    out["checksum"] = float(state_checksum(local, mesh))
    env, _ = make("fishing-v1")
    cfg = ppo.PPOConfig(**CFG)
    ts = ppo.make_train_state(env, cfg, torch.Generator().manual_seed(10 + mesh.rank), "cpu")
    replicate(ts, mesh)
    out["replicated"] = {k: v.detach().clone() for k, v in ts.params().items()}
    out["sum"] = float(mesh.all_reduce(torch.tensor([mesh.rank + 1.0]))[0])
    out["max"] = float(mesh.all_reduce(torch.tensor([mesh.rank + 1.0]), "max")[0])
    out["plain"] = train_job(mesh, job)
    return out


@pytest.fixture(scope="module")
def jax_case():
    """JAX's sharded plain step and the port's inputs built from it."""
    import jax
    from test_torch_ppo import _jax_draws, _port_state

    import gym_fishing_tpu as gft
    from gym_fishing_tpu.agents.ppo import PPOConfig, make_train_state, train_step
    from gym_fishing_tpu.batch import batched_reset as j_batched_reset
    from gym_fishing_tpu.shard import make_mesh as j_make_mesh
    from gym_fishing_tpu.shard import replicate as j_replicate
    from gym_fishing_tpu.shard import shard_batch as j_shard_batch

    jmesh = j_make_mesh(2)
    jenv, jparams = gft.make("fishing-v1", sigma=0.05)
    cfg = PPOConfig(**CFG)
    key = jax.random.key(3)
    ts0 = make_train_state(jenv, cfg, key)
    step = jax.jit(lambda t, b, k: train_step(jenv, jparams, cfg, t, b, k))
    j_ts, _, j_met = step(j_replicate(ts0, jmesh),
                          j_shard_batch(j_batched_reset(jenv, jparams, cfg.num_envs), jmesh), key)
    act, env_n, k_perm = _jax_draws(key, cfg, "gaussian", jenv.config.n_actions)
    n = cfg.num_envs * cfg.num_steps
    perms = [torch.from_numpy(np.array(jax.random.permutation(k, n)))
             for k in jax.random.split(k_perm, cfg.epochs)]
    job = dict(env_id="fishing-v1", env_kw=dict(sigma=0.05), cfg=CFG, form="plain",
               state=_port_state(ts0), iterations=1, act_noise=[act], env_noise=[env_n],
               perms=[perms])
    return j_ts, j_met, job


@pytest.fixture(scope="module")
def ranks(jax_case):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYTHONPATH", TESTS)   # the children import this file by name
        return spawn_ranks("test_torch_shard:rank_body", 2, jax_case[2], timeout_s=120)


@pytest.fixture(scope="module")
def single(jax_case):
    """The port's single-process step from the same state and draws."""
    job = jax_case[2]
    env, params = make("fishing-v1", sigma=0.05)
    ts, bstate, met = ppo.train_step(env, params, ppo.PPOConfig(**CFG), job["state"].clone(),
                                     batched_reset(env, params, CFG["num_envs"], "cpu"),
                                     perms=job["perms"][0], act_noise=job["act_noise"][0],
                                     env_noise=job["env_noise"][0])
    return ts, met, bstate


# ------------------------------------------------------------ in-process

def test_mesh_of_one_rank_without_a_group():
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.world, mesh.device, mesh.group) == (0, 1, torch.device("cpu"), None)
    assert mesh.env_slice(12) == slice(0, 12)
    x = torch.tensor([2.0])
    assert mesh.all_reduce(x) is x and float(x) == 2.0
    with pytest.raises(ValueError, match="one process each"):
        make_mesh(2, device="cpu")


def test_env_slice_and_shard_batch_by_rank():
    glob = _global_bstate(8)
    mesh = Mesh(rank=1, world=2, device=torch.device("cpu"))
    assert mesh.env_slice(8) == slice(4, 8)
    local = shard_batch(glob, mesh)
    assert torch.equal(local.env.stock, glob.env.stock[4:])
    assert torch.equal(local.episode_length, glob.episode_length[4:])
    with pytest.raises(ValueError, match="divisible"):
        mesh.env_slice(7)


def test_fold_rank_is_the_identity_at_rank_0():
    assert fold_rank(123, 0) == 123
    keys = {fold_rank(123, r) for r in range(64)}
    assert len(keys) == 64 and all(0 <= k < 1 << 64 for k in keys)
    assert fold_rank((1 << 64) - 1, 1) < 1 << 64


def test_state_checksum_is_a_float64_sum_of_the_float_leaves():
    glob = _global_bstate(8)
    want = float(glob.env.stock.double().sum() + glob.env.harvest.double().sum()
                 + glob.episode_return.double().sum())
    got = state_checksum(glob)
    assert got.dtype == torch.float64 and float(got) == pytest.approx(want, rel=1e-12)


def test_distributed_init_is_a_no_op_without_a_coordinator(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    distributed_init()
    assert not torch.distributed.is_initialized()


def test_distributed_init_refuses_the_cpu_when_asked_for_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed_init(f"file://{tmp_path}/rendezvous", 1, 0)
    assert not torch.distributed.is_initialized()


def test_train_step_refuses_the_fused_forms_under_a_mesh():
    env, params = make("fishing-v1")
    cfg = ppo.PPOConfig(num_envs=256, num_steps=8, fused_update=True)
    ts = ppo.make_train_state(env, cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = Mesh(rank=0, world=2, device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="make_sharded_fused_train_step"):
        ppo.train_step(env, params, cfg, ts, batched_reset(env, params, 128, "cpu"),
                       torch.Generator(), mesh=mesh)


# ------------------------------------------------------------ two gloo ranks

def test_shard_batch_gives_each_rank_its_envs(ranks):
    glob = _global_bstate(8)
    for r in ranks:
        assert (r["rank"], r["world"]) == (ranks.index(r), 2)
        sl = slice(4 * r["rank"], 4 * r["rank"] + 4)
        assert torch.equal(r["local_stock"], glob.env.stock[sl])
        assert torch.equal(r["local_t"], glob.env.t[sl])


def test_host_local_to_global_refuses_unequal_shares_on_every_rank(ranks):
    for r in ranks:
        assert r["uneven"] is not None and "between 4 and 5 envs" in r["uneven"]


def test_replicate_gives_every_rank_rank_0s_weights(ranks):
    env, _ = make("fishing-v1")
    want = ppo.make_train_state(env, ppo.PPOConfig(**CFG), torch.Generator().manual_seed(10),
                                "cpu").params()
    for r in ranks:
        for k, v in want.items():
            assert torch.equal(r["replicated"][k], v.detach()), k


def test_sharded_state_checksum_is_the_global_batchs(ranks):
    want = float(state_checksum(_global_bstate(8)))
    for r in ranks:
        assert r["checksum"] == pytest.approx(want, rel=1e-12)


def test_all_reduce_sum_and_max(ranks):
    assert [(r["sum"], r["max"]) for r in ranks] == [(3.0, 2.0), (3.0, 2.0)]


def test_plain_step_replicas_are_bit_identical(ranks):
    a, b = (r["plain"] for r in ranks)
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
        assert torch.equal(a["m"][k], b["m"][k]) and torch.equal(a["v"][k], b["v"][k]), k
    assert a["metrics"] == b["metrics"] and a["count"] == b["count"] == 4
    assert a["checksum"] == b["checksum"]


def test_plain_step_under_the_mesh_matches_the_single_process(ranks, single):
    ts, met, _ = single
    for r in ranks:
        for k, v in ts.params().items():
            np.testing.assert_allclose(r["plain"]["params"][k].numpy(), v.detach().numpy(),
                                       atol=1e-5, err_msg=k)
        for k, v in met.items():
            np.testing.assert_allclose(r["plain"]["metrics"][0][k], float(v), rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_plain_step_under_the_mesh_matches_jax_on_a_2_device_mesh(ranks, jax_case):
    from gym_fishing_tpu_torch.convert import actor_critic_to_numpy

    j_ts, j_met, _ = jax_case
    want = {".".join(p): np.asarray(v) for p, v in _flat(j_ts.params["params"])}
    got = {".".join(p): v for p, v in _flat(actor_critic_to_numpy(ranks[0]["plain"]["params"])
                                            ["params"])}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=1e-5, err_msg=k)
    for k, v in j_met.items():
        np.testing.assert_allclose(ranks[0]["plain"]["metrics"][0][k], float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_sharded_rollout_slices_draw_the_global_noise(ranks, single):
    """The ranks' end states, put together, are the single process's: each
    rank stepped its envs on the global batch's draws."""
    _, met, bstate = single
    for name in ("episode_return", "episode_length", "mean_reward"):
        for r in ranks:
            np.testing.assert_allclose(r["plain"]["metrics"][0][name], float(met[name]),
                                       rtol=1e-6, err_msg=name)
    for name in ("stock", "harvest", "t"):
        got = torch.cat([getattr(r["plain"]["bstate"].env, name) for r in ranks])
        np.testing.assert_allclose(got.numpy(), getattr(bstate.env, name).numpy(), atol=1e-6,
                                   err_msg=name)
    got = torch.cat([r["plain"]["bstate"].episode_length for r in ranks])
    assert torch.equal(got, bstate.episode_length)


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v
