"""The port's SAC learner (agents/sac.py) against the JAX learner.

The comparison starts from networks converted from the flax trees and feeds
the port JAX's own draws, rebuilt from its key schedule: each step splits
its key into (k_act, k_env, k_upd); the action draws normal(k_act, (B, 1)),
the env normal(k_env, (2, B)); k_upd splits into one key per update and
each into (k_samp, k_pi, k_pi2): the sample indices are randint(k_samp,
(batch,), 0, max(size, 1)), the target action's normals normal(k_pi, ...)
and the actor loss's normal(k_pi2, ...). Tolerances are float32 ones: the
parameters, Adam's moments and the metrics to 1e-5, the squashed sample's
arithmetic to 1e-6.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_fishing_tpu as gft
import gym_fishing_tpu_torch as gtt
from gym_fishing_tpu.agents import sac as jsac
from gym_fishing_tpu_torch.agents import sac
from gym_fishing_tpu_torch.analysis.simulate import _simulate_steps
from gym_fishing_tpu_torch.convert import (
    SAC_ACTOR_NAMES,
    actor_critic_to_numpy,
    adam_from_numpy,
    off_policy_from_numpy,
)
from test_torch_ppo_rnn import _adam, _assert_close_to_tree, _np

make = functools.partial(gtt.make, device="cpu")

torch.set_num_threads(1)


def test_replay_buffer_wraparound_and_sampling():
    buf = sac.buffer_init(8, 1, 1, device="cpu")
    obs = torch.arange(6, dtype=torch.float32)[:, None]
    sac.buffer_add(buf, obs, obs, obs[:, 0], obs, torch.zeros(6))
    assert buf.size == 6 and buf.ptr == 6
    # wrap: 6 more into a capacity of 8 leaves ptr at 4
    sac.buffer_add(buf, obs + 10, obs + 10, obs[:, 0] + 10, obs + 10, torch.zeros(6))
    assert buf.size == 8 and buf.ptr == 4
    stored = buf.obs[:, 0].numpy()
    assert set(stored.tolist()) == {12, 13, 14, 15, 4, 5, 10, 11}   # newest overwrote oldest
    o, a, r, no, d = sac.buffer_sample(buf, 32, torch.Generator().manual_seed(0))
    assert o.shape == (32, 1) and np.isin(o[:, 0].numpy(), stored).all()
    # the JAX buffer agrees, row for row
    jbuf = jsac.buffer_init(8, 1, 1)
    for shift in (0, 10):
        x = jnp.arange(6, dtype=jnp.float32)[:, None] + shift
        jbuf = jsac.buffer_add(jbuf, x, x, x[:, 0], x, jnp.zeros(6))
    np.testing.assert_array_equal(buf.obs.numpy(), np.asarray(jbuf.obs))
    assert (buf.ptr, buf.size) == (int(jbuf.ptr), int(jbuf.size))


def test_sample_squashed_matches_jax():
    """Away from saturation: where tanh nears 1, log(1 - act^2 + 1e-6)
    turns a last-bit difference of the two libraries' tanh into a relative
    error of ~2 ulp / (1 - act^2), which no float32 bar can hold."""
    rng = np.random.default_rng(3)
    mean = (0.3 * rng.standard_normal((64, 1))).astype(np.float32)
    log_std = rng.uniform(-2, -0.5, (64, 1)).astype(np.float32)
    key = jax.random.key(7)
    j_act, j_logp = jsac.sample_squashed(jnp.asarray(mean), jnp.asarray(log_std), key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (64, 1), jnp.float32)))
    act, logp = sac.sample_squashed(torch.from_numpy(mean), torch.from_numpy(log_std), noise)
    np.testing.assert_allclose(act.numpy(), np.asarray(j_act), rtol=0, atol=1e-6)
    np.testing.assert_allclose(logp.numpy(), np.asarray(j_logp), rtol=1e-6, atol=1e-6)


def _step_draws(key, cfg, sizes):
    """sac_train_step's draws from its key; `sizes` the buffer's size at
    each update."""
    k_act, k_env, k_upd = jax.random.split(key, 3)
    B = cfg.num_envs
    out = {"act_noise": jax.random.normal(k_act, (B, 1), jnp.float32),
           "env_noise": jax.random.normal(k_env, (2, B), jnp.float32)}
    idx, tn, an = [], [], []
    for k, size in zip(jax.random.split(k_upd, cfg.updates_per_step), sizes):
        k_samp, k_pi, k_pi2 = jax.random.split(k, 3)
        idx.append(jax.random.randint(k_samp, (cfg.batch_size,), 0,
                                      jnp.maximum(jnp.asarray(size, jnp.int32), 1)))
        tn.append(jax.random.normal(k_pi, (cfg.batch_size, 1), jnp.float32))
        an.append(jax.random.normal(k_pi2, (cfg.batch_size, 1), jnp.float32))
    out.update(sample_idx=np.stack(idx), target_noise=np.stack(tn), actor_noise=np.stack(an))
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def test_sac_train_steps_match_jax():
    """Three steps of 16 envs, 2 updates each, into a capacity of 40 (not a
    multiple of 16: the third insert wraps), batches of 32."""
    jenv, jparams = gft.make("fishing-v1", sigma=0.1, Tmax=5)
    cfg = jsac.SACConfig(num_envs=16, buffer_size=40, batch_size=32, updates_per_step=2,
                         lr=1e-3)
    j_state, alpha_tx = jsac.make_sac_state(jenv, cfg, jax.random.key(2), jparams)
    j_step = jax.jit(functools.partial(jsac.sac_train_step, jenv, jparams, cfg, alpha_tx))

    env, params = make("fishing-v1", sigma=0.1, Tmax=5)
    pcfg = sac.SACConfig(**dataclasses.asdict(cfg))
    state = sac.make_sac_state(env, pcfg, env_params=params, device="cpu")
    state.actor = off_policy_from_numpy("sac_actor", _np(j_state.actor.params), device="cpu")
    state.critic = off_policy_from_numpy("critic", _np(j_state.critic.params), device="cpu")
    state.target_critic = off_policy_from_numpy("critic", _np(j_state.target_critic_params),
                                                device="cpu")
    state.actor_opt = sac.adam_init(dict(state.actor.named_parameters()))
    state.critic_opt = sac.adam_init(dict(state.critic.named_parameters()))
    np.testing.assert_array_equal(state.obs.numpy(), np.asarray(j_state.obs))

    for i in range(3):
        key = jax.random.key(100 + i)
        size = min((i + 1) * cfg.num_envs, cfg.buffer_size)
        draws = _step_draws(key, cfg, [size] * cfg.updates_per_step)
        j_state, j_met = j_step(j_state, key)
        state, met = sac.sac_train_step(env, params, pcfg, state, **draws)
        assert (state.buffer.ptr, state.buffer.size) == (int(j_state.buffer.ptr),
                                                         int(j_state.buffer.size))
        for f in ("obs", "action", "reward", "next_obs", "done"):
            np.testing.assert_allclose(getattr(state.buffer, f).numpy(),
                                       np.asarray(getattr(j_state.buffer, f)), rtol=0,
                                       atol=1e-6, err_msg=f"step {i} buffer {f}")
        assert set(met) == set(j_met)
        for name, want in j_met.items():
            np.testing.assert_allclose(float(met[name]), float(want), rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i} {name}")
    assert state.buffer.ptr == 8
    _assert_close_to_tree(actor_critic_to_numpy(state.actor, SAC_ACTOR_NAMES),
                          j_state.actor.params, atol=1e-5)
    _assert_close_to_tree(actor_critic_to_numpy(state.critic), j_state.critic.params, atol=1e-5)
    _assert_close_to_tree(actor_critic_to_numpy(state.target_critic),
                          j_state.target_critic_params, atol=1e-5)
    for opt, j_ts, names in ((state.actor_opt, j_state.actor, SAC_ACTOR_NAMES),
                             (state.critic_opt, j_state.critic, None)):
        adam = _adam(j_ts.opt_state)
        _assert_close_to_tree(actor_critic_to_numpy(opt.m, names), adam.mu, atol=1e-5)
        _assert_close_to_tree(actor_critic_to_numpy(opt.v, names), adam.nu, atol=1e-5)
        assert opt.count == int(adam.count) == 6
        conv = adam_from_numpy(_np(adam.mu), _np(adam.nu), adam.count, names, device="cpu")
        assert conv.count == 6 and set(conv.m) == set(opt.m)
    alpha_adam = _adam(j_state.alpha_opt_state)
    np.testing.assert_allclose(float(state.log_alpha), float(j_state.log_alpha), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(state.alpha_opt.m["log_alpha"]), float(alpha_adam.mu),
                               rtol=1e-5, atol=1e-7)
    assert state.alpha_opt.count == int(alpha_adam.count) == 6
    np.testing.assert_allclose(state.env_state.env.stock.numpy(),
                               np.asarray(j_state.env_state.env.stock), rtol=0, atol=1e-6)


def test_sac_refuses_a_discrete_env():
    env, params = make("fishing-v0")
    with pytest.raises(ValueError, match="continuous"):
        sac.make_sac_state(env, sac.SACConfig(num_envs=8), env_params=params, device="cpu")


def test_sac_train_and_policy():
    env, params = make("fishing-v1", sigma=0.05)
    cfg = sac.SACConfig(num_envs=32, buffer_size=1024, batch_size=64, updates_per_step=2)
    state, hist = sac.sac_train(env, cfg, steps=60, seed=0, env_params=params, device="cpu")
    assert len(hist) == 3 and hist[-1]["buffer_size"] == 1024
    assert all(np.isfinite(h["critic_loss"]) for h in hist)
    pol = sac.SACPolicy(env, state)
    a, st = pol.predict(np.zeros((5, 1), np.float32))
    assert a.shape == (5, 1) and st is None and np.all(np.abs(a) <= 1)
    # .act takes simulate_mdp's device path
    _, act, rew = _simulate_steps(env, pol, 4, params, int(params.Tmax), torch.zeros(100, 2, 4))
    assert act.shape == (100, 4, 1) and bool(torch.isfinite(rew).all())
