"""The port's recurrent PPO (agents/ppo_rnn.py) against the JAX learner.

Every comparison starts from weights converted from the flax tree and feeds
the port JAX's own draws, rebuilt from its key schedule: train_step splits
its key into (k_roll, k_perm); collect_rollout splits k_roll into one key
per step and each step key into (k_act, k_env); actions draw
normal(k_act, mean.shape) or Gumbel-max over gumbel(k_act, logits.shape),
the env draws normal(k_env, (2, B)); each epoch permutes the envs with
permutation(split(k_perm, epochs)[e], num_envs). Tolerances are float32
ones: the GRU cell's arithmetic to 1e-6, the loss and its gradients to 1e-5
relative, the parameters and Adam's moments after one train step to 1e-5.
"""

import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_fishing_tpu as gft
import gym_fishing_tpu_torch as gtt
from gym_fishing_tpu.agents import ppo_rnn as jrnn
from gym_fishing_tpu.batch import batched_reset as j_batched_reset
from gym_fishing_tpu_torch.agents import ppo_rnn
from gym_fishing_tpu_torch.agents.ppo import TrainState, action_logp_entropy
from gym_fishing_tpu_torch.analysis.simulate import _simulate_host_steps
from gym_fishing_tpu_torch.batch import batched_reset
from gym_fishing_tpu_torch.convert import (
    actor_critic_to_numpy,
    adam_state_from_numpy,
    recurrent_actor_critic_from_numpy,
)

make = functools.partial(gtt.make, device="cpu")
recurrent_actor_critic_from_numpy = functools.partial(recurrent_actor_critic_from_numpy,
                                                      device="cpu")

torch.set_num_threads(1)

ENV_IDS = {"gaussian": "fishing-may-obs-v1", "categorical": "fishing-v0"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _adam(opt_state):
    for leaf in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return leaf
    raise AssertionError("no Adam state")


def _assert_close_to_tree(got, want, atol, rtol=0.0):
    want = _np(want)
    got = {jax.tree_util.keystr(k): v for k, v in jax.tree.leaves_with_path(got)}
    paths = jax.tree.leaves_with_path(want)
    assert len(got) == len(paths)
    for k, ref in paths:
        np.testing.assert_allclose(got[jax.tree_util.keystr(k)], ref, rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(k))


def _port_cfg(cfg):
    return ppo_rnn.RPPOConfig(**dataclasses.asdict(cfg))


def _port_state(params) -> TrainState:
    model = recurrent_actor_critic_from_numpy(_np(params))
    zeros = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    return TrainState(model=model, m=zeros, v={n: z.clone() for n, z in zeros.items()})


def _rollout_draws(key, cfg, head, n_actions):
    """collect_rollout's draws from its key: act [T, B, A], env [T, 2, B]."""
    act, env = [], []
    for step_key in jax.random.split(key, cfg.num_steps):
        k_act, k_env = jax.random.split(step_key)
        if head == "gaussian":
            act.append(jax.random.normal(k_act, (cfg.num_envs, 1), jnp.float32))
        else:
            act.append(jax.random.gumbel(k_act, (cfg.num_envs, n_actions), jnp.float32))
        env.append(jax.random.normal(k_env, (2, cfg.num_envs), jnp.float32))
    to_t = lambda xs: torch.from_numpy(np.stack([np.asarray(x) for x in xs]))  # noqa: E731
    return to_t(act), to_t(env)


def test_gru_cell_matches_flax():
    """flax's GRUCell and the port's cell (and torch.nn.GRUCell with bias_hh
    = [0, 0, bhn]) on random weights and inputs agree to 1e-6."""
    H, D, B = 16, 8, 32
    cell = fnn.GRUCell(H)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, D)).astype(np.float32)
    h = rng.standard_normal((B, H)).astype(np.float32)
    params = cell.init(jax.random.key(0), jnp.asarray(h), jnp.asarray(x))
    # random biases too (flax initialises them to zero)
    params = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
                          params)
    want, _ = cell.apply(params, jnp.asarray(h), jnp.asarray(x))

    from gym_fishing_tpu_torch.convert import _gru_from_flax
    named = _gru_from_flax(_np(params)["params"])
    port = ppo_rnn.GRUCell(D, H)
    with torch.no_grad():
        for n, p in port.named_parameters():
            p.copy_(torch.from_numpy(np.array(named[n])))
    got = port(torch.from_numpy(x), torch.from_numpy(h)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)

    ref = torch.nn.GRUCell(D, H)
    with torch.no_grad():
        ref.weight_ih.copy_(torch.from_numpy(np.array(named["weight_ih"])))
        ref.bias_ih.copy_(torch.from_numpy(np.array(named["bias_ih"])))
        ref.weight_hh.copy_(torch.from_numpy(np.array(named["weight_hh"])))
        b_hn = torch.from_numpy(np.array(named["bias_hn"]))
        ref.bias_hh.copy_(torch.cat([torch.zeros(2 * H), b_hn]))
    np.testing.assert_allclose(ref(torch.from_numpy(x), torch.from_numpy(h)).detach().numpy(),
                               np.asarray(want), rtol=0, atol=1e-6)
    # and back to the flax layout
    back = actor_critic_to_numpy({f"gru.{n}": p for n, p in port.named_parameters()})
    _assert_close_to_tree(back["params"]["gru"], params["params"], atol=0)


def test_replay_matches_collection_exactly():
    """Re-running the GRU over the collected segment from its h_start with the
    done-reset convention gives the collection's log-probs and values."""
    env, params = make("fishing-may-obs-v1", Tmax=7)   # short episodes
    cfg = ppo_rnn.RPPOConfig(num_envs=16, num_steps=20, hidden=32)
    ts = ppo_rnn.make_rppo_state(env, cfg, torch.Generator().manual_seed(0), device="cpu")
    bstate = batched_reset(env, params, cfg.num_envs)
    h0 = ppo_rnn.init_hidden(cfg, cfg.num_envs, device="cpu")
    _, _, _, h_start, traj, _ = ppo_rnn.collect_rollout(
        env, params, cfg, ts.model, bstate, h0, torch.Generator().manual_seed(1))
    assert bool(traj.done.any())   # episode boundaries inside the segment
    with torch.no_grad():
        dists, values = ppo_rnn.replay_sequence(ts.model, traj.obs, traj.done, h_start)
    logp, _ = action_logp_entropy(dists, traj.action, continuous=True)
    assert dists[1].shape == dists[0].shape == (20, 16, 1)
    np.testing.assert_allclose(logp.numpy(), traj.logp.numpy(), atol=1e-5)
    np.testing.assert_allclose(values.numpy(), traj.value.numpy(), atol=1e-5)


@pytest.mark.parametrize("head", ["gaussian", "categorical"])
def test_collect_rollout_matches_jax(head):
    env_id = ENV_IDS[head]
    jenv, jparams = gft.make(env_id, sigma=0.1, Tmax=9)
    cfg = jrnn.RPPOConfig(num_envs=16, num_steps=20, hidden=32)
    ts = jrnn.make_rppo_state(jenv, cfg, jax.random.key(3))
    key = jax.random.key(11)
    _, j_obs, j_h, _, j_traj, j_last = jax.jit(
        lambda b, h, k: jrnn.collect_rollout(jenv, jparams, cfg, ts, b, h, k)
    )(j_batched_reset(jenv, jparams, cfg.num_envs), jrnn.init_hidden(cfg, cfg.num_envs), key)
    act, env_n = _rollout_draws(key, cfg, head, jenv.config.n_actions)

    env, params = make(env_id, sigma=0.1, Tmax=9)
    model = recurrent_actor_critic_from_numpy(_np(ts.params))
    _, obs, h, _, traj, last = ppo_rnn.collect_rollout(
        env, params, _port_cfg(cfg), model, batched_reset(env, params, cfg.num_envs),
        ppo_rnn.init_hidden(cfg, cfg.num_envs, device="cpu"), act_noise=act, env_noise=env_n)
    assert bool(traj.done.any())
    np.testing.assert_array_equal(traj.done.numpy(), np.asarray(j_traj.done))
    if head == "categorical":
        np.testing.assert_array_equal(traj.action.numpy(), np.asarray(j_traj.action))
    for name in ("obs", "action", "logp", "value", "reward", "episode_return"):
        np.testing.assert_allclose(getattr(traj, name).numpy(),
                                   np.asarray(getattr(j_traj, name)), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(h.numpy(), np.asarray(j_h), rtol=0, atol=1e-5)
    np.testing.assert_allclose(obs.numpy(), np.asarray(j_obs), rtol=0, atol=1e-5)
    np.testing.assert_allclose(last.numpy(), np.asarray(j_last), rtol=0, atol=1e-5)


@pytest.mark.parametrize("head", ["gaussian", "categorical"])
def test_rppo_loss_and_grads_match_jax(head):
    """rppo_loss over a replayed [T, B] segment with episode ends inside."""
    jenv, _ = gft.make(ENV_IDS[head])
    cfg = jrnn.RPPOConfig(hidden=32, ent_coef=0.01)
    ts = jrnn.make_rppo_state(jenv, cfg, jax.random.key(5))
    rng = np.random.default_rng(1)
    T, B, H = 12, 8, cfg.hidden
    obs = rng.uniform(-1, 1, (T, B, 1)).astype(np.float32)
    if head == "gaussian":
        action = rng.standard_normal((T, B, 1)).astype(np.float32)
    else:
        action = rng.integers(0, jenv.config.n_actions, (T, B)).astype(np.int32)
    done = rng.uniform(size=(T, B)) < 0.15
    old_logp, old_value, adv, ret = (rng.standard_normal((T, B)).astype(np.float32) * s
                                     for s in (0.3, 1.0, 1.0, 1.0))
    h0 = (0.5 * rng.standard_normal((B, H))).astype(np.float32)
    batch = (obs, action, done, old_logp, old_value, adv, ret, h0)
    continuous = head == "gaussian"
    (_, j_met), j_grads = jax.value_and_grad(
        lambda p: jrnn.rppo_loss(ts.apply_fn, p, cfg, tuple(map(jnp.asarray, batch)),
                                 continuous), has_aux=True)(ts.params)
    model = recurrent_actor_critic_from_numpy(_np(ts.params))
    loss, met = ppo_rnn.rppo_loss(model, _port_cfg(cfg), tuple(map(torch.from_numpy, batch)),
                                  continuous)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    for name, want in j_met.items():
        np.testing.assert_allclose(float(met[name].detach()), float(want), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    g_tree = actor_critic_to_numpy(dict(zip([n for n, _ in model.named_parameters()], grads)))
    _assert_close_to_tree(g_tree, j_grads, atol=1e-7, rtol=1e-5)


def _train_step_pair(head):
    env_id = ENV_IDS[head]
    jenv, jparams = gft.make(env_id, sigma=0.1, Tmax=9)
    cfg = jrnn.RPPOConfig(num_envs=16, num_steps=20, epochs=2, num_minibatches=2, hidden=32,
                          ent_coef=0.01)
    ts0 = jrnn.make_rppo_state(jenv, cfg, jax.random.key(4))
    key = jax.random.key(23)
    j_ts, _, j_h, j_met = jax.jit(
        lambda ts, b, h, k: jrnn.train_step(jenv, jparams, cfg, ts, b, h, k)
    )(ts0, j_batched_reset(jenv, jparams, cfg.num_envs), jrnn.init_hidden(cfg, cfg.num_envs),
      key)

    k_roll, k_perm = jax.random.split(key)
    act, env_n = _rollout_draws(k_roll, cfg, head, jenv.config.n_actions)
    perms = [torch.from_numpy(np.array(jax.random.permutation(k, cfg.num_envs)))
             for k in jax.random.split(k_perm, cfg.epochs)]
    env, params = make(env_id, sigma=0.1, Tmax=9)
    ts = _port_state(ts0.params)
    ts, _, h, met = ppo_rnn.train_step(
        env, params, _port_cfg(cfg), ts, batched_reset(env, params, cfg.num_envs),
        ppo_rnn.init_hidden(cfg, cfg.num_envs, device="cpu"), perms=perms, act_noise=act,
        env_noise=env_n)
    return (j_ts, j_h, j_met), (ts, h, met)


@pytest.mark.parametrize("head", ["gaussian", "categorical"])
def test_train_step_matches_jax(head):
    (j_ts, j_h, j_met), (ts, h, met) = _train_step_pair(head)
    _assert_close_to_tree(actor_critic_to_numpy(ts.model), j_ts.params, atol=1e-5)
    adam = _adam(j_ts.opt_state)
    _assert_close_to_tree(actor_critic_to_numpy(ts.m), adam.mu, atol=1e-5)
    _assert_close_to_tree(actor_critic_to_numpy(ts.v), adam.nu, atol=1e-5)
    assert ts.count == int(adam.count) == ts.step == int(j_ts.step) == 4
    m, v, count = adam_state_from_numpy(_np(adam.mu), _np(adam.nu), adam.count)
    assert count == 4 and set(m) == set(ts.m) == set(v)
    np.testing.assert_allclose(h.numpy(), np.asarray(j_h), rtol=0, atol=1e-5)
    assert set(met) == set(j_met)
    for name, want in j_met.items():
        np.testing.assert_allclose(float(met[name]), float(want), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_train_runs_both_heads_and_refuses_a_ragged_cut():
    for env_id in ("fishing-may-obs-v1", "fishing-v0"):
        env, params = make(env_id)
        cfg = ppo_rnn.RPPOConfig(num_envs=32, num_steps=16, epochs=2, num_minibatches=2,
                                 hidden=32)
        ts, hist = ppo_rnn.train(env, cfg, iterations=3, env_params=params, seed=0,
                                 device="cpu")
        assert len(hist) == 3 and all(np.isfinite(x["loss"]) for x in hist)
        assert ts.count == 3 * 2 * 2
    with pytest.raises(ValueError, match="multiple"):
        ppo_rnn.train(env, ppo_rnn.RPPOConfig(num_envs=30, num_minibatches=4), iterations=1,
                      device="cpu")


def test_policy_predict_threads_and_resets_the_hidden():
    env, params = make("fishing-may-obs-v1")
    cfg = ppo_rnn.RPPOConfig(num_envs=8, num_steps=8, hidden=16)
    ts = ppo_rnn.make_rppo_state(env, cfg, torch.Generator().manual_seed(0), device="cpu")
    pol = ppo_rnn.RecurrentPPOPolicy(env, ts, cfg)
    assert not hasattr(pol, "act")
    obs = np.full((4, 1), -0.25, np.float32)
    a1, h1 = pol.predict(obs)
    assert a1.shape == (4, 1) and h1.shape == (4, 16)
    a2, h2 = pol.predict(obs, state=h1)
    assert not np.allclose(h1, h2)          # the hidden evolves
    start = np.array([True, False, True, False])
    a3, h3 = pol.predict(obs, state=h1, episode_start=start)
    np.testing.assert_array_equal(h3[start], h1[start])   # reset, then one step
    np.testing.assert_array_equal(h3[~start], h2[~start])
    # simulate_mdp takes the host loop for it, threading the hidden
    obs_s, act_s, rew_s = _simulate_host_steps(env, pol, 3, params, 5,
                                               torch.zeros(5, 2, 3))
    assert act_s.shape == (5, 3, 1) and bool(torch.isfinite(rew_s).all())
