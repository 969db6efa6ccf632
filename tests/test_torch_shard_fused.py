"""The sharded fused PPO step (gym_fishing_tpu_torch/shard/fused_ppo.py) and
K1's sharded launcher (gym_fishing_tpu_torch/kernels/sharded.py) on the CPU,
where K4, K2 and K1 run their plain twins, with two gloo ranks.

One job of two ranks runs once for the module (``shard.launch.spawn_ranks``,
a ``file://`` rendezvous, one thread each):

- the sharded fused step at 1024 envs x 16 steps, 1 epoch x 1 minibatch,
  hidden 32 (tests/test_shard_fused.py's configuration) from weights
  converted from the flax tree, against JAX's
  ``make_sharded_fused_train_step`` on a 2-device mesh. JAX's device d
  keys its kernel with ``fold_in(split(key)[0], d)``, but the Mosaic
  interpreter's PRNG yields zero bits whatever the key (see
  tests/test_torch_policy_rollout_kernel.py), so each rank's planes are the
  z = 0 planes; the tile permutation is JAX's ``k_perm``'s, the same on
  every device. Tolerances are tests/test_shard_fused.py:56-72's. The
  start and ent_coef 0.01 are tests/test_torch_policy_rollout_kernel.py's
  fused step pair's (`_jax_case`'s desynchronised envs, the Gaussian mean
  at -0.5). From JAX's own start every env follows the same z = 0
  trajectory, the advantages are all but equal, and the normalised
  advantages, hence pg_loss, are rounding noise amplified by a std near 0;
  and at z = 0 without an entropy term the log_std gradient is the mean
  normalised advantage, rounding noise that Adam's first step divides by
  its eps. Two frameworks that sum in different orders share neither;
- two iterations at 2 epochs x 2 minibatches from a generator: the
  replicas stay bit-identical and the loss finite;
- `sharded_rollout` at 2048 envs (1024 per rank) x 20 steps against JAX's
  ``sharded_pallas_rollout`` on a 2-device mesh in interpret mode, from
  zero noise planes (the interpreter's draws), at
  tests/test_torch_rollout_kernel.py's tolerances; and from one seed the
  two ranks draw different streams.

The rank body imports no JAX; the JAX side runs in the test process.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import gym_fishing_tpu_torch as gtt
from gym_fishing_tpu_torch.agents import ppo, ppo_fused
from gym_fishing_tpu_torch.batch import batched_reset
from gym_fishing_tpu_torch.shard import Mesh
from gym_fishing_tpu_torch.shard.fused_ppo import make_sharded_fused_train_step
from gym_fishing_tpu_torch.shard.launch import spawn_ranks

make = functools.partial(gtt.make, device="cpu")

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
FUSED = dict(num_envs=1024, num_steps=16, hidden=32, epochs=1, num_minibatches=1,
             ent_coef=0.01, fused_update=True, fused_rollout=True)
K1_B, K1_T, K1_PARAM = 2048, 20, 0.5
STOCK_ATOL, REWARD_ATOL = 2e-6, 2e-5   # tests/test_kernels.py


def rank_body(mesh, job):
    from gym_fishing_tpu_torch.shard.launch import rollout_job, train_job

    out = {"rank": mesh.rank, "one": train_job(mesh, job["one"]),
           "multi": train_job(mesh, job["multi"]), "k1": rollout_job(mesh, job["k1"])}
    seeded = dict(job["k1"], kernel_kw={})
    seeded["stock"] = torch.full_like(job["k1"]["stock"], 0.75)
    out["k1_seeded"] = rollout_job(mesh, seeded)
    return out


@pytest.fixture(scope="module")
def jax_case():
    import jax
    import jax.numpy as jnp
    from test_torch_policy_rollout_kernel import _jax_case, _np, _port_bstate
    from test_torch_ppo import _port_state

    import gym_fishing_tpu as gft
    from gym_fishing_tpu.kernels import make_scalars
    from gym_fishing_tpu.kernels.sharded import sharded_pallas_rollout
    from gym_fishing_tpu.shard import make_mesh, replicate, shard_batch
    from gym_fishing_tpu.shard.fused_ppo import (
        make_sharded_fused_train_step as j_make_step,
    )

    jmesh = make_mesh(2)
    jenv, jparams, cfg, ts0, jb = _jax_case("fishing-v1", dict(sigma=0.05), True, **FUSED)
    tree = _np(ts0.params)
    tree["params"]["pi_mean"]["bias"] = tree["params"]["pi_mean"]["bias"] - 0.5
    ts0 = ts0.replace(params=jax.tree.map(jnp.asarray, tree))
    key = jax.random.key(5)
    step = jax.jit(j_make_step(jenv, jparams, cfg, jmesh))
    j_ts, j_bst, j_met = step(replicate(ts0, jmesh), shard_batch(jb, jmesh), key)
    _, k_perm = jax.random.split(key)
    local_tiles = cfg.num_envs // 2 * cfg.num_steps // 2048
    perms = [torch.from_numpy(np.array(jax.random.permutation(k, local_tiles)))
             for k in jax.random.split(k_perm, cfg.epochs)]
    z0 = torch.zeros((2, cfg.num_steps, cfg.num_envs))   # action z = 0, process z = 0
    one = dict(env_id="fishing-v1", env_kw=dict(sigma=0.05), cfg=FUSED, form="fused",
               state=_port_state(ts0), bstate=_port_bstate(jb), iterations=1,
               rollout_noise=[z0], perms=[perms])
    multi = dict(one, cfg=dict(FUSED, epochs=2, num_minibatches=2), iterations=2,
                 rollout_noise=None, perms=None, seed=9)

    stock0 = np.random.default_rng(4).uniform(0.3, 1.2, K1_B).astype(np.float32)
    k_env, k_params = gft.make("fishing-v1", dtype=jnp.float32, sigma=0.05, Tmax=13)
    scal = make_scalars(k_params, K1_PARAM, seed=3, n_actions=k_env.config.n_actions)
    j_k1 = sharded_pallas_rollout(jmesh, jnp.asarray(stock0), jnp.zeros((K1_B,), jnp.int32),
                                  scal, K1_T, rows_per_block=8, interpret=True)
    k1 = dict(env_id="fishing-v1", env_kw=dict(sigma=0.05, Tmax=13),
              stock=torch.from_numpy(stock0), t=torch.zeros(K1_B, dtype=torch.int32),
              policy="escapement", policy_param=K1_PARAM, num_steps=K1_T, seed=3,
              kernel_kw=dict(noise=torch.zeros((1, K1_T, K1_B))))
    return (j_ts, j_bst, j_met, j_k1), dict(one=one, multi=multi, k1=k1)


@pytest.fixture(scope="module")
def ranks(jax_case):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYTHONPATH", TESTS)   # the children import this file by name
        return spawn_ranks("test_torch_shard_fused:rank_body", 2, jax_case[1], timeout_s=120)


# ------------------------------------------------------------ two gloo ranks

def test_sharded_fused_step_matches_jax_on_a_2_device_mesh(ranks, jax_case):
    from test_torch_shard import _flat

    from gym_fishing_tpu_torch.convert import actor_critic_to_numpy

    j_ts = jax_case[0][0]
    want = {".".join(p): np.asarray(v) for p, v in _flat(j_ts.params["params"])}
    for r in ranks:
        got = {".".join(p): v for p, v in _flat(actor_critic_to_numpy(r["one"]["params"])
                                                ["params"])}
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=2e-6, err_msg=k)


def test_sharded_fused_step_env_state_matches_jax(ranks, jax_case):
    j_bst = jax_case[0][1]
    stock = torch.cat([r["one"]["bstate"].env.stock for r in ranks])
    np.testing.assert_allclose(stock.numpy(), np.asarray(j_bst.env.stock), rtol=1e-6, atol=1e-7)
    t = torch.cat([r["one"]["bstate"].env.t for r in ranks])
    np.testing.assert_array_equal(t.numpy(), np.asarray(j_bst.env.t))


def test_sharded_fused_step_metrics_match_jax(ranks, jax_case):
    j_met = jax_case[0][2]
    for r in ranks:
        for name in ("pg_loss", "v_loss", "approx_kl", "episode_return", "mean_reward"):
            np.testing.assert_allclose(r["one"]["metrics"][0][name], float(j_met[name]),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def test_sharded_fused_step_launches_nothing_on_the_cpu(ranks):
    for r in ranks:
        assert r["one"]["launches"] == {"rollout": 0, "grad": 0, "adam": 0, "policy": 0}


def test_multi_epoch_sharded_fused_params_stay_replicated(ranks):
    a, b = (r["multi"] for r in ranks)
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    assert a["metrics"] == b["metrics"] and np.isfinite(a["metrics"][-1]["loss"])
    assert a["count"] == b["count"] == 2 * 2 * 2
    assert a["checksum"] == b["checksum"]


def test_sharded_rollout_matches_jax_on_a_2_device_mesh(ranks, jax_case):
    j_k1 = jax_case[0][3]
    for r in ranks:
        sl = slice(r["rank"] * K1_B // 2, (r["rank"] + 1) * K1_B // 2)
        out = r["k1"]["out"]
        np.testing.assert_allclose(out["stock"].numpy(), np.asarray(j_k1.stock)[sl],
                                   atol=STOCK_ATOL)
        np.testing.assert_array_equal(out["t"].numpy(), np.asarray(j_k1.t)[sl])
        np.testing.assert_array_equal(out["ep_count"].numpy(), np.asarray(j_k1.ep_count)[sl])
        for name in ("reward", "ep_ret", "ep_ret_sum"):
            np.testing.assert_allclose(out[name].numpy(), np.asarray(getattr(j_k1, name))[sl],
                                       atol=REWARD_ATOL, err_msg=name)


def test_sharded_rollout_ranks_draw_different_streams(ranks):
    """Both ranks start every env at the same stock from the same seed: only
    the rank's fold of the Philox key tells their noise apart."""
    a, b = (r["k1_seeded"]["out"] for r in ranks)
    assert not torch.equal(a["stock"], b["stock"])
    assert a["next_offset"] == b["next_offset"]


# ------------------------------------------------------------ in-process

def test_sharded_fused_requires_fused_update():
    env, params = make("fishing-v1", sigma=0.05)
    mesh = Mesh(rank=0, world=2, device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="train_step"):
        make_sharded_fused_train_step(env, params, ppo.PPOConfig(num_envs=1024), mesh)
    with pytest.raises(ValueError, match="divisible"):
        make_sharded_fused_train_step(env, params,
                                      ppo.PPOConfig(num_envs=1001, fused_update=True), mesh)


def test_sharded_fused_step_at_one_rank_is_the_full_form_bit_for_bit():
    """A mesh of one rank without a group: the same step as train_step's
    full form, from the same generator."""
    env, params = make("fishing-v1", sigma=0.05)
    cfg = ppo.PPOConfig(**dict(FUSED, num_envs=256, epochs=2, num_minibatches=2))
    ts0 = ppo.make_train_state(env, cfg, torch.Generator().manual_seed(0), "cpu")
    step = make_sharded_fused_train_step(env, params, cfg,
                                         Mesh(rank=0, world=1, device=torch.device("cpu")))
    ts_a, bs_a, met_a = step(ts0.clone(), batched_reset(env, params, 256, "cpu"),
                             torch.Generator().manual_seed(4))
    ts_b, bs_b, met_b = ppo.train_step(env, params, cfg, ts0.clone(),
                                       batched_reset(env, params, 256, "cpu"),
                                       torch.Generator().manual_seed(4))
    for k, v in ts_b.params().items():
        assert torch.equal(ts_a.params()[k], v), k
    assert torch.equal(bs_a.env.stock, bs_b.env.stock)
    assert {k: float(v) for k, v in met_a.items()} == pytest.approx(
        {k: float(v) for k, v in met_b.items()}, rel=0, abs=0, nan_ok=True)


def test_sharded_fused_step_refuses_a_batch_of_the_wrong_share():
    env, params = make("fishing-v1", sigma=0.05)
    cfg = ppo.PPOConfig(**FUSED)
    ts = ppo.make_train_state(env, cfg, torch.Generator().manual_seed(0), "cpu")
    step = make_sharded_fused_train_step(env, params, cfg,
                                         Mesh(rank=0, world=2, device=torch.device("cpu")))
    with pytest.raises(ValueError, match="rank's 512"):
        step(ts, batched_reset(env, params, 1024, "cpu"), torch.Generator())


def test_fused_adam_refuses_a_mesh():
    env, _ = make("fishing-v1")
    cfg = ppo.PPOConfig(num_envs=256, num_steps=8, fused_update=True, fused_adam=True)
    ts = ppo.make_train_state(env, cfg, torch.Generator().manual_seed(0), "cpu")
    packed = torch.zeros((8, 256 * 8))
    with pytest.raises(NotImplementedError, match="single-device"):
        ppo_fused.fused_epoch_scan_adam(cfg, ts, packed, 1, 1, torch.Generator(),
                                        mesh=Mesh(rank=0, world=2, device=torch.device("cpu")))


def test_sharded_step_ignores_fused_adam():
    """As JAX's sharded path: the step runs K2 and the optimizer outside it."""
    env, params = make("fishing-v1", sigma=0.05)
    cfg = ppo.PPOConfig(**dict(FUSED, num_envs=256, fused_adam=True))
    ts0 = ppo.make_train_state(env, cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = Mesh(rank=0, world=1, device=torch.device("cpu"))
    ts_a, _, _ = make_sharded_fused_train_step(env, params, cfg, mesh)(
        ts0.clone(), batched_reset(env, params, 256, "cpu"), torch.Generator().manual_seed(1))
    ts_b, _, _ = make_sharded_fused_train_step(
        env, params, dataclasses.replace(cfg, fused_adam=False), mesh)(
        ts0.clone(), batched_reset(env, params, 256, "cpu"), torch.Generator().manual_seed(1))
    for k, v in ts_b.params().items():
        assert torch.equal(ts_a.params()[k], v), k
