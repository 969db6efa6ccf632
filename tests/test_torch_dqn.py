"""The port's double-DQN learner (agents/dqn.py) against the JAX learner.

The comparison starts from the Q-network converted from the flax tree and
feeds the port JAX's own draws, rebuilt from its key schedule: each step
splits its key into (k_eps, k_rand, k_env, k_upd); exploration compares
uniform(k_eps, (B,)) with epsilon and takes randint(k_rand, (B,), 0,
n_actions) where it explores; the env draws normal(k_env, (2, B)); k_upd
splits into one key per update, each drawing the sample indices
randint(k, (batch,), 0, max(size, 1)). Tolerances are float32 ones: the
parameters, Adam's moments and the loss to 1e-5; the epsilon schedule and
the Huber loss's arithmetic to 1e-6.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import gym_fishing_tpu as gft
import gym_fishing_tpu_torch as gtt
from gym_fishing_tpu.agents import dqn as jdqn
from gym_fishing_tpu_torch.agents import dqn
from gym_fishing_tpu_torch.analysis.simulate import _simulate_steps
from gym_fishing_tpu_torch.convert import (
    Q_NETWORK_NAMES,
    actor_critic_to_numpy,
    off_policy_from_numpy,
)
from test_torch_ppo_rnn import _adam, _assert_close_to_tree, _np

make = functools.partial(gtt.make, device="cpu")

torch.set_num_threads(1)

SCHEMES = {"relative": dict(), "proportional": dict(scheme="proportional", n_actions=8)}


def test_epsilon_and_huber_match_jax():
    cfg = jdqn.DQNConfig(eps_decay_steps=7, eps_end=0.03)
    for step in (0, 1, 3, 6, 7, 50):
        want = float(jdqn._epsilon(cfg, jnp.asarray(step, jnp.int32)))
        assert abs(dqn._epsilon(dqn.DQNConfig(**dataclasses.asdict(cfg)), step) - want) <= 1e-6
    rng = np.random.default_rng(0)
    pred, target = (rng.standard_normal(256).astype(np.float32) * 2 for _ in range(2))
    want = float(optax.huber_loss(jnp.asarray(pred), jnp.asarray(target)).mean())
    got = float(F.huber_loss(torch.from_numpy(pred), torch.from_numpy(target), delta=1.0))
    assert abs(got - want) <= 1e-6


def _step_draws(key, cfg, n_actions, size):
    k_eps, k_rand, k_env, k_upd = jax.random.split(key, 4)
    B = cfg.num_envs
    out = {
        "explore_u": jax.random.uniform(k_eps, (B,)),
        "rand_actions": jax.random.randint(k_rand, (B,), 0, n_actions, jnp.int32),
        "env_noise": jax.random.normal(k_env, (2, B), jnp.float32),
        "sample_idx": np.stack([
            jax.random.randint(k, (cfg.batch_size,), 0,
                               jnp.maximum(jnp.asarray(size, jnp.int32), 1))
            for k in jax.random.split(k_upd, cfg.updates_per_step)]),
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.mark.parametrize("double", [True, False])
@pytest.mark.parametrize("scheme", ["relative", "proportional"])
def test_dqn_train_steps_match_jax(scheme, double):
    """Four steps of 16 envs, 2 updates each, into a capacity of 40: epsilon
    anneals from 1 over 4 steps, so the later steps mix greedy and random
    actions, and the third insert wraps."""
    overrides = dict(SCHEMES[scheme], sigma=0.1, Tmax=3)
    jenv, jparams = gft.make("fishing-v0", **overrides)
    cfg = jdqn.DQNConfig(num_envs=16, buffer_size=40, batch_size=32, updates_per_step=2,
                         eps_decay_steps=4, double=double, lr=1e-3)
    j_state = jdqn.make_dqn_state(jenv, cfg, jax.random.key(2), jparams)
    j_step = jax.jit(functools.partial(jdqn.dqn_train_step, jenv, jparams, cfg))

    env, params = make("fishing-v0", **overrides)
    pcfg = dqn.DQNConfig(**dataclasses.asdict(cfg))
    state = dqn.make_dqn_state(env, pcfg, env_params=params, device="cpu")
    state.q = off_policy_from_numpy("q", _np(j_state.q.params), device="cpu")
    state.target_q = off_policy_from_numpy("q", _np(j_state.target_params), device="cpu")
    state.opt = dqn.adam_init(dict(state.q.named_parameters()))
    np.testing.assert_array_equal(state.obs.numpy(), np.asarray(j_state.obs))

    n_explore = 0
    for i in range(4):
        key = jax.random.key(200 + i)
        draws = _step_draws(key, cfg, jenv.config.n_actions,
                            min((i + 1) * cfg.num_envs, cfg.buffer_size))
        n_explore += int((draws["explore_u"] < dqn._epsilon(pcfg, i)).sum())
        j_state, j_met = j_step(j_state, key)
        state, met = dqn.dqn_train_step(env, params, pcfg, state, **draws)
        for f in ("obs", "action", "reward", "next_obs", "done"):
            np.testing.assert_allclose(getattr(state.buffer, f).numpy(),
                                       np.asarray(getattr(j_state.buffer, f)), rtol=0,
                                       atol=1e-6, err_msg=f"step {i} buffer {f}")
        assert set(met) == set(j_met) and state.step == int(j_state.step) == i + 1
        for name, want in j_met.items():
            np.testing.assert_allclose(float(met[name]), float(want), rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i} {name}")
    assert 16 < n_explore < 64   # both greedy and random actions were taken
    assert (state.buffer.ptr, state.buffer.size) == (int(j_state.buffer.ptr),
                                                     int(j_state.buffer.size)) == (24, 40)
    _assert_close_to_tree(actor_critic_to_numpy(state.q, Q_NETWORK_NAMES), j_state.q.params,
                          atol=1e-5)
    _assert_close_to_tree(actor_critic_to_numpy(state.target_q, Q_NETWORK_NAMES),
                          j_state.target_params, atol=1e-5)
    adam = _adam(j_state.q.opt_state)
    _assert_close_to_tree(actor_critic_to_numpy(state.opt.m, Q_NETWORK_NAMES), adam.mu,
                          atol=1e-5)
    _assert_close_to_tree(actor_critic_to_numpy(state.opt.v, Q_NETWORK_NAMES), adam.nu,
                          atol=1e-5)
    assert state.opt.count == int(adam.count) == 8


def test_dqn_predict_contract_on_the_proportional_grid():
    env, params = make("fishing-v0", scheme="proportional", n_actions=8, sigma=0.0)
    cfg = dqn.DQNConfig(num_envs=64, buffer_size=1 << 12, batch_size=256, eps_decay_steps=100)
    state, history = dqn.dqn_train(env, cfg, steps=20, seed=1, env_params=params,
                                   device="cpu")
    assert len(history) == 20 and all(np.isfinite(h["loss"]) for h in history)
    pol = dqn.DQNPolicy(env, state)
    a, st = pol.predict(np.zeros((5, 1), np.float32))
    assert a.shape == (5,) and a.dtype == np.int32 and st is None
    assert np.all((a >= 0) & (a < 8))
    # .act takes simulate_mdp's device path
    T = int(params.Tmax)
    _, act, rew = _simulate_steps(env, pol, 2, params, T, torch.zeros(T, 2, 2))
    assert act.shape == (T, 2) and bool(torch.isfinite(rew).all())


def test_dqn_predict_threads_the_carried_harvest_under_the_relative_scheme():
    jenv, jparams = gft.make("fishing-v0")
    cfg = jdqn.DQNConfig(num_envs=8, hidden=16)
    j_state = jdqn.make_dqn_state(jenv, cfg, jax.random.key(4), jparams)
    env, params = make("fishing-v0")
    state = dqn.make_dqn_state(env, dqn.DQNConfig(num_envs=8, hidden=16), env_params=params,
                               device="cpu")
    state.q = off_policy_from_numpy("q", _np(j_state.q.params), device="cpu")
    obs = np.linspace(-1, 1, 7, dtype=np.float32)[:, None]
    carried = None
    j_pol, pol = jdqn.DQNPolicy(jenv, j_state, jparams), dqn.DQNPolicy(env, state, params)
    for _ in range(3):
        j_a, j_h = j_pol.predict(obs, state=carried)
        a, h = pol.predict(obs, state=carried)
        np.testing.assert_array_equal(a, j_a)
        np.testing.assert_allclose(h, j_h, rtol=1e-6)
        carried = h
    assert h.shape == (7,)


def test_dqn_refuses_a_continuous_env():
    env, params = make("fishing-v1")
    with pytest.raises(ValueError, match="discrete"):
        dqn.make_dqn_state(env, dqn.DQNConfig(num_envs=8), env_params=params, device="cpu")
