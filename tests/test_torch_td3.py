"""The port's TD3 learner (agents/td3.py) against the JAX learner.

The comparison starts from networks converted from the flax trees and feeds
the port JAX's own draws, rebuilt from its key schedule: each step splits
its key into (k_act, k_env, k_upd); exploration draws normal(k_act, (B, 1)),
the env normal(k_env, (2, B)); k_upd splits into one key per update and
each into (k_samp, k_smooth): the sample indices randint(k_samp, (batch,),
0, max(size, 1)) and the smoothing normals normal(k_smooth, (batch, 1)).
Under the tests' x64 mode JAX draws the two normals in float64 and carries
the actions in float64 through the env step; the port takes them in
float32, so the stored actions and observations agree to 1e-6 and the
parameters and Adam's moments to 1e-5.
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
from gym_fishing_tpu.agents import td3 as jtd3
from gym_fishing_tpu_torch.agents import td3
from gym_fishing_tpu_torch.analysis.simulate import _simulate_steps
from gym_fishing_tpu_torch.convert import (
    TD3_ACTOR_NAMES,
    actor_critic_to_numpy,
    off_policy_from_numpy,
)
from test_torch_ppo_rnn import _adam, _assert_close_to_tree, _np

make = functools.partial(gtt.make, device="cpu")

torch.set_num_threads(1)


def _step_draws(key, cfg, size):
    k_act, k_env, k_upd = jax.random.split(key, 3)
    B = cfg.num_envs
    idx, smooth = [], []
    for k in jax.random.split(k_upd, cfg.updates_per_step):
        k_samp, k_smooth = jax.random.split(k)
        idx.append(jax.random.randint(k_samp, (cfg.batch_size,), 0,
                                      jnp.maximum(jnp.asarray(size, jnp.int32), 1)))
        smooth.append(jax.random.normal(k_smooth, (cfg.batch_size, 1)))
    out = {"act_noise": jax.random.normal(k_act, (B, 1)),
           "env_noise": jax.random.normal(k_env, (2, B), jnp.float32),
           "sample_idx": np.stack(idx), "smooth_noise": np.stack(smooth)}
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def test_td3_train_steps_match_jax():
    """Two steps of 16 envs with 3 updates each and policy_delay 2: the
    actor steps at updates 1, 3 and 5 and holds at 0, 2 and 4."""
    jenv, jparams = gft.make("fishing-v1", sigma=0.1, Tmax=5)
    cfg = jtd3.TD3Config(num_envs=16, buffer_size=40, batch_size=32, updates_per_step=3,
                         policy_delay=2, lr=1e-3)
    j_state = jtd3.make_td3_state(jenv, cfg, jax.random.key(2), jparams)
    j_step = jax.jit(functools.partial(jtd3.td3_train_step, jenv, jparams, cfg))

    env, params = make("fishing-v1", sigma=0.1, Tmax=5)
    pcfg = td3.TD3Config(**dataclasses.asdict(cfg))
    state = td3.make_td3_state(env, pcfg, env_params=params, device="cpu")
    state.actor = off_policy_from_numpy("td3_actor", _np(j_state.actor.params), device="cpu")
    state.target_actor = off_policy_from_numpy("td3_actor", _np(j_state.target_actor_params),
                                               device="cpu")
    state.critic = off_policy_from_numpy("critic", _np(j_state.critic.params), device="cpu")
    state.target_critic = off_policy_from_numpy("critic", _np(j_state.target_critic_params),
                                                device="cpu")
    state.actor_opt = td3.adam_init(dict(state.actor.named_parameters()))
    state.critic_opt = td3.adam_init(dict(state.critic.named_parameters()))

    for i, (updates, actor_steps) in enumerate(((3, 1), (6, 3))):
        key = jax.random.key(300 + i)
        draws = _step_draws(key, cfg, (i + 1) * cfg.num_envs)
        j_state, j_met = j_step(j_state, key)
        state, met = td3.td3_train_step(env, params, pcfg, state, **draws)
        assert state.update_count == int(j_state.update_count) == updates
        j_count = int(_adam(j_state.actor.opt_state).count)
        assert state.actor_opt.count == j_count == int(j_state.actor.step) == actor_steps
        assert state.critic_opt.count == updates
        for f in ("obs", "action", "reward", "next_obs", "done"):
            np.testing.assert_allclose(getattr(state.buffer, f).numpy(),
                                       np.asarray(getattr(j_state.buffer, f)), rtol=0,
                                       atol=1e-6, err_msg=f"step {i} buffer {f}")
        assert set(met) == set(j_met)
        for name, want in j_met.items():
            np.testing.assert_allclose(float(met[name]), float(want), rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i} {name}")
        for mod, want, names in ((state.actor, j_state.actor.params, TD3_ACTOR_NAMES),
                                 (state.target_actor, j_state.target_actor_params,
                                  TD3_ACTOR_NAMES),
                                 (state.critic, j_state.critic.params, None),
                                 (state.target_critic, j_state.target_critic_params, None)):
            _assert_close_to_tree(actor_critic_to_numpy(mod, names), want, atol=1e-5)
        for opt, j_ts, names in ((state.actor_opt, j_state.actor, TD3_ACTOR_NAMES),
                                 (state.critic_opt, j_state.critic, None)):
            adam = _adam(j_ts.opt_state)
            _assert_close_to_tree(actor_critic_to_numpy(opt.m, names), adam.mu, atol=1e-5)
            _assert_close_to_tree(actor_critic_to_numpy(opt.v, names), adam.nu, atol=1e-5)


def test_td3_delayed_update_counter_and_policy():
    env, params = make("fishing-v1", sigma=0.0)
    cfg = td3.TD3Config(num_envs=8, batch_size=64, buffer_size=1 << 10, updates_per_step=3,
                        policy_delay=2)
    state = td3.make_td3_state(env, cfg, torch.Generator().manual_seed(0), params, "cpu")
    target0 = [p.clone() for p in state.target_actor.parameters()]
    state, met = td3.td3_train_step(env, params, cfg, state, torch.Generator().manual_seed(1))
    assert state.update_count == 3 and state.actor_opt.count == 1
    assert any(not torch.equal(p, q) for p, q in zip(state.target_actor.parameters(), target0))
    pol = td3.TD3Policy(env, state)
    a, st = pol.predict(np.zeros((5, 1), np.float32))
    assert a.shape == (5, 1) and st is None and np.all(np.abs(a) <= 1)
    _, act, rew = _simulate_steps(env, pol, 3, params, 10, torch.zeros(10, 2, 3))
    assert act.shape == (10, 3, 1) and bool(torch.isfinite(rew).all())
    _, hist = td3.td3_train(env, cfg, steps=3, env_params=params, device="cpu")
    assert len(hist) == 2 and all(np.isfinite(h["critic_loss"]) for h in hist)


def test_td3_refuses_a_discrete_env():
    env, params = make("fishing-v0")
    with pytest.raises(ValueError, match="continuous"):
        td3.make_td3_state(env, td3.TD3Config(num_envs=8), env_params=params, device="cpu")
