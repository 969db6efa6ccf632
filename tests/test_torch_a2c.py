"""The port's A2C learner against the JAX learner (agents/a2c.py).

Every comparison starts from weights converted from the flax tree and feeds
the port JAX's own draws, rebuilt from its key schedule: a2c_train_step
hands its key to collect_rollout, which splits it into one key per step and
each step key into (k_act, k_env); actions draw normal(k_act, mean.shape)
or Gumbel-max over gumbel(k_act, logits.shape), the env draws
normal(k_env, (2, B)). Tolerances are float32 ones (the frameworks sum in
different orders): the loss and its gradients to 1e-5 relative, the
parameters and RMSProp's second moments after one step to 1e-5, and the
optimizer's arithmetic alone to 1e-7.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gym_fishing_tpu as gft
import gym_fishing_tpu_torch as gtt
from gym_fishing_tpu.agents import a2c as ja2c
from gym_fishing_tpu.batch import batched_reset as j_batched_reset
from gym_fishing_tpu_torch.agents import a2c
from gym_fishing_tpu_torch.batch import batched_reset
from gym_fishing_tpu_torch.convert import actor_critic_from_numpy, actor_critic_to_numpy

make = functools.partial(gtt.make, device="cpu")
actor_critic_from_numpy = functools.partial(actor_critic_from_numpy, device="cpu")

torch.set_num_threads(1)

ENV_IDS = {"gaussian": "fishing-v1", "categorical": "fishing-v0"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rms_nu(opt_state):
    """The ScaleByRmsState's nu inside optax.chain(clip, rmsprop)'s state."""
    for leaf in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "nu")):
        if hasattr(leaf, "nu"):
            return leaf.nu
    raise AssertionError("no RMSProp state")


def _port_state(ts) -> a2c.A2CState:
    model = actor_critic_from_numpy(_np(ts.params))
    return a2c.A2CState(model=model, nu={n: torch.zeros_like(p)
                                         for n, p in model.named_parameters()})


def _assert_close_to_tree(got, want, atol):
    want = _np(want)
    got = {jax.tree_util.keystr(k): v for k, v in jax.tree.leaves_with_path(got)}
    paths = jax.tree.leaves_with_path(want)
    assert len(got) == len(paths)
    for k, ref in paths:
        np.testing.assert_allclose(got[jax.tree_util.keystr(k)], ref, rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(k))


@pytest.mark.parametrize("max_grad_norm", [1e6, 0.05])
def test_rmsprop_matches_optax(max_grad_norm):
    """Three steps of the hand-written optimizer against optax.chain(
    clip_by_global_norm, rmsprop(eps inside the root)) from nu = 0."""
    rng = np.random.default_rng(0)
    shapes = {"pi_d1.weight": (8, 1), "pi_d1.bias": (8,), "log_std": (1,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    cfg = a2c.A2CConfig(lr=7e-3, max_grad_norm=max_grad_norm)
    tx = optax.chain(optax.clip_by_global_norm(max_grad_norm),
                     optax.rmsprop(cfg.lr, decay=0.99, eps=1e-5))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt = tx.init(jp)

    class _Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for k, v in params.items():
                self.register_parameter(k.replace(".", "_"),
                                        torch.nn.Parameter(torch.from_numpy(v.copy())))

    model = _Model()
    state = a2c.A2CState(model=model, nu={n: torch.zeros_like(p)
                                          for n, p in model.named_parameters()})
    for _ in range(3):
        grads = {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
                 for k, s in shapes.items()}
        upd, opt = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, opt, jp)
        jp = optax.apply_updates(jp, upd)
        a2c.rmsprop_apply(state, {k.replace(".", "_"): torch.from_numpy(v)
                                  for k, v in grads.items()}, cfg)
    nu = _rms_nu(opt)
    for k in shapes:
        name = k.replace(".", "_")
        np.testing.assert_allclose(dict(model.named_parameters())[name].detach().numpy(),
                                   np.asarray(jp[k]), rtol=0, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(state.nu[name].numpy(), np.asarray(nu[k]), rtol=0,
                                   atol=1e-7, err_msg=k)
    assert state.step == 3


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("head", ["gaussian", "categorical"])
def test_a2c_loss_and_grads_match_jax(head, normalize):
    jenv, _ = gft.make(ENV_IDS[head])
    cfg = ja2c.A2CConfig(hidden=32, ent_coef=0.01, normalize_advantage=normalize)
    ts = ja2c.make_a2c_state(jenv, cfg, jax.random.key(5))
    rng = np.random.default_rng(1)
    n = 256
    obs = rng.uniform(-1, 1, (n, 1)).astype(np.float32)
    if head == "gaussian":
        action = rng.standard_normal((n, 1)).astype(np.float32)
    else:
        action = rng.integers(0, jenv.config.n_actions, n).astype(np.int32)
    adv = rng.standard_normal(n).astype(np.float32)
    ret = rng.standard_normal(n).astype(np.float32)
    continuous = head == "gaussian"
    (_, j_met), j_grads = jax.value_and_grad(
        lambda p: ja2c.a2c_loss(ts.apply_fn, p, cfg,
                                tuple(map(jnp.asarray, (obs, action, adv, ret))), continuous),
        has_aux=True)(ts.params)
    model = actor_critic_from_numpy(_np(ts.params))
    batch = tuple(torch.from_numpy(x) for x in (obs, action, adv, ret))
    loss, met = a2c.a2c_loss(model, a2c.A2CConfig(**dataclasses.asdict(cfg)), batch, continuous)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    names = [k for k, _ in model.named_parameters()]
    for name, want in j_met.items():
        np.testing.assert_allclose(float(met[name].detach()), float(want), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    g_tree = actor_critic_to_numpy(dict(zip(names, grads)))
    _assert_close_to_tree(g_tree, j_grads, atol=1e-6)


def _step_pair(head, **overrides):
    """One JAX a2c_train_step and the port's, from the same weights and draws."""
    env_id = ENV_IDS[head]
    jenv, jparams = gft.make(env_id, sigma=0.1)
    cfg = ja2c.A2CConfig(**{**dict(num_envs=32, num_steps=8, hidden=32, ent_coef=0.01),
                            **overrides})
    key = jax.random.key(23)
    ts0 = ja2c.make_a2c_state(jenv, cfg, jax.random.key(4))
    j_ts, _, j_met = jax.jit(
        lambda ts, bs, k: ja2c.a2c_train_step(jenv, jparams, cfg, ts, bs, k)
    )(ts0, j_batched_reset(jenv, jparams, cfg.num_envs), key)

    b, act, env_draws = cfg.num_envs, [], []
    for step_key in jax.random.split(key, cfg.num_steps):
        k_act, k_env = jax.random.split(step_key)
        if head == "gaussian":
            act.append(jax.random.normal(k_act, (b, 1), jnp.float32))
        else:
            act.append(jax.random.gumbel(k_act, (b, jenv.config.n_actions), jnp.float32))
        env_draws.append(jax.random.normal(k_env, (2, b), jnp.float32))
    to_t = lambda xs: torch.from_numpy(np.stack([np.asarray(x) for x in xs]))  # noqa: E731

    env, params = make(env_id, sigma=0.1)
    state = _port_state(ts0)
    state, _, met = a2c.a2c_train_step(env, params, a2c.A2CConfig(**dataclasses.asdict(cfg)),
                                       state, batched_reset(env, params, cfg.num_envs),
                                       act_noise=to_t(act), env_noise=to_t(env_draws))
    return (j_ts, j_met), (state, met)


@pytest.mark.parametrize("head,normalize", [("gaussian", False), ("gaussian", True),
                                            ("categorical", False)])
def test_a2c_train_step_matches_jax(head, normalize):
    (j_ts, j_met), (state, met) = _step_pair(head, normalize_advantage=normalize,
                                             gae_lambda=0.95)
    _assert_close_to_tree(actor_critic_to_numpy(state.model), j_ts.params, atol=1e-5)
    _assert_close_to_tree(actor_critic_to_numpy(state.nu), _rms_nu(j_ts.opt_state), atol=1e-5)
    assert state.step == int(j_ts.step) == 1
    assert set(met) == set(j_met)
    for name, want in j_met.items():
        np.testing.assert_allclose(float(met[name]), float(want), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_a2c_train_and_policy_on_the_discrete_env():
    env, params = make("fishing-v0", sigma=0.05)
    state, hist = a2c.a2c_train(env, a2c.A2CConfig(num_envs=64, num_steps=16), seed=1,
                                iterations=3, env_params=params, device="cpu")
    assert len(hist) == 3 and np.isfinite(hist[-1]["loss"]) and state.step == 3
    act, st = a2c.A2CPolicy(env, state).predict(np.zeros((5, 1), np.float32))
    assert act.shape == (5,) and act.dtype == np.int32 and st is None


def test_a2c_train_step_is_deterministic():
    env, params = make("fishing-v1", sigma=0.1)
    cfg = a2c.A2CConfig(num_envs=32, num_steps=8)
    state0 = a2c.make_a2c_state(env, cfg, torch.Generator().manual_seed(7), device="cpu")
    outs = []
    for _ in range(2):
        state = a2c.A2CState(model=copy.deepcopy(state0.model),
                             nu={k: v.clone() for k, v in state0.nu.items()})
        state, _, met = a2c.a2c_train_step(env, params, cfg, state,
                                           batched_reset(env, params, cfg.num_envs),
                                           torch.Generator().manual_seed(3))
        outs.append((state, met))
    for p, q in zip(outs[0][0].model.parameters(), outs[1][0].model.parameters()):
        assert torch.equal(p, q)
    assert float(outs[0][1]["loss"]) == float(outs[1][1]["loss"])
