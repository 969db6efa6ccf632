"""The port's observation window (envs/wrappers.py) and the batched engine
over nested state and per-instance params, against the JAX package.

Every comparison feeds both packages the same N(0,1) draws: the single-env
step gets numpy-made (xi, eta) through `step_xi`, the batched engine JAX's
own (2, B) plane of each step (`jax.random.normal(key, (2, B))`). float64 at
atol 1e-12, the bar of tests/test_exactness.py. One plain PPO train step on
the stacked env is held to tests/test_torch_ppo.py's float32 tolerances.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ppo import _assert_steps_agree, _step_pair

import gym_fishing_tpu as gft
import gym_fishing_tpu_torch as gtt
from gym_fishing_tpu.batch import batched_reset as j_reset
from gym_fishing_tpu.batch import batched_step as j_step
from gym_fishing_tpu.envs.wrappers import stack_observations as j_stack
from gym_fishing_tpu_torch.batch import batched_reset, batched_step
from gym_fishing_tpu_torch.envs.wrappers import ObsStackEnv, StackedState, stack_observations

# the port's entry points default to the card; these tests run on the CPU
make = functools.partial(gtt.make, device="cpu")

torch.set_num_threads(1)

ATOL = 1e-12
B = 48
FIELDS = ("obs", "reward", "done", "collapsed", "quota", "harvest", "episode_return",
          "episode_length")


def _leaves(x):
    return [np.asarray(v) for v in jax.tree.leaves(x)]


def _assert_state(tstate, jstate):
    """Every field of a port BatchState against JAX's, in tree order."""
    got = [tstate.env.env.stock, tstate.env.env.harvest, tstate.env.env.t, tstate.env.window,
           tstate.episode_return, tstate.episode_length]
    for g, w in zip(got, _leaves(jstate)):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)


def test_window_semantics():
    env, params = make("fishing-may-obs-v1", dtype=torch.float64)
    senv = stack_observations(env, 3)
    assert senv.id == "fishing-may-obs-v1-stack3" and senv.observation_space.shape == (3,)
    assert senv.action_space == env.action_space and senv.config == env.config
    s = senv.reset(params)
    obs0 = float(env.get_obs(params, s.env)[0])
    assert s.window.tolist() == [obs0] * 3          # reset broadcasts obs0
    xs = [0.3, -1.2, 0.5, 0.0]
    seen = []
    for xi in xs:
        s, ts = senv.step_xi(params, s, torch.tensor([-0.6], dtype=torch.float64), xi, -xi)
        seen.append(float(s.window[-1]))            # the newest obs is last
        assert torch.equal(ts.obs, s.window)
        want = ([obs0] * 3 + seen)[-3:]
        assert s.window.tolist() == want
    assert s.t == s.env.t == len(xs) and s.stock == s.env.stock
    stock = senv.get_fish_population(params, s.window)
    assert float(stock) == pytest.approx(float(env.get_fish_population(params, s.window[-1:])))


def test_wrapper_refuses_bad_k_and_a_windowed_inner_env():
    env, _ = make("fishing-v1")
    with pytest.raises(ValueError, match="k must be >= 1"):
        ObsStackEnv(env, 0)
    with pytest.raises(ValueError, match="scalar-observation"):
        stack_observations(stack_observations(env, 2), 2)


@pytest.mark.parametrize("env_id", ["fishing-may-obs-v1", "fishing-v0"])
def test_step_xi_matches_jax(env_id):
    jenv, jp = gft.make(env_id, dtype=jnp.float64, Tmax=30)
    tenv, tp = make(env_id, dtype=torch.float64, Tmax=30)
    jenv, tenv = j_stack(jenv, 4), stack_observations(tenv, 4)
    js, ts_ = jenv.reset(jp), tenv.reset(tp)
    np.testing.assert_array_equal(ts_.window.numpy(), np.asarray(js.window))
    rng = np.random.default_rng(3)
    step = jax.jit(jenv.step_xi)
    for _ in range(25):
        xi, eta = rng.standard_normal(2)
        if tenv.config.scheme == "continuous":
            a = rng.uniform(-1.0, -0.3, 1)
            ja, ta = jnp.asarray(a), torch.from_numpy(a)
        else:
            a = int(rng.integers(0, 3))
            ja, ta = jnp.int32(a), torch.tensor(a, dtype=torch.int32)
        js, jts = step(jp, js, ja, jnp.float64(xi), jnp.float64(eta))
        ts_, tts = tenv.step_xi(tp, ts_, ta, xi, eta)
        for g, w in ((ts_.window, js.window), (ts_.env.stock, js.env.stock),
                     (ts_.env.harvest, js.env.harvest), (tts.obs, jts.obs),
                     (tts.reward, jts.reward)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
        assert bool(tts.done) == bool(jts.done)


@pytest.mark.parametrize("env_id,overrides", [
    ("fishing-may-obs-v1", {"sigma": 0.05, "sigma_m": 0.2, "Tmax": 11}),
    ("fishing-v0", {"sigma": 0.1, "Tmax": 9}),
])
def test_stacked_batched_step_autoreset_matches_jax(env_id, overrides):
    """The batched engine carries a StackedState: reset windows, auto-reset
    of done instances (window refilled with the reset obs), and the
    episode statistics, step by step against JAX."""
    jenv, jp = gft.make(env_id, dtype=jnp.float64, **overrides)
    tenv, tp = make(env_id, dtype=torch.float64, **overrides)
    jenv, tenv = j_stack(jenv, 4), stack_observations(tenv, 4)
    jstate, tstate = j_reset(jenv, jp, B), batched_reset(tenv, tp, B)
    assert isinstance(tstate.env, StackedState) and tstate.env.window.shape == (B, 4)
    assert tstate.env.env.t.shape == (B,)
    _assert_state(tstate, jstate)
    rng = np.random.default_rng(0)
    step = jax.jit(j_step, static_argnums=(0,))
    key = jax.random.key(1)
    n_done = 0
    for _ in range(30):
        if tenv.config.scheme == "continuous":
            a = rng.uniform(-1.0, -0.5, (B, 1))
            a[rng.random(B) < 0.05] = 1.0   # harvest everything: collapse + reset
            ja, ta = jnp.asarray(a), torch.from_numpy(a)
        else:
            a = rng.integers(0, 3, B).astype(np.int32)
            ja, ta = jnp.asarray(a), torch.from_numpy(a)
        key, sub = jax.random.split(key)
        noise = np.array(jax.random.normal(sub, (2, B), jnp.float64))
        jstate, jts = step(jenv, jp, jstate, ja, sub)
        tstate, tts = batched_step(tenv, tp, tstate, ta, torch.from_numpy(noise))
        for name in FIELDS:
            np.testing.assert_allclose(getattr(tts, name).numpy(),
                                       np.asarray(getattr(jts, name)), atol=ATOL, rtol=0,
                                       err_msg=name)
        _assert_state(tstate, jstate)
        n_done += int(tts.done.sum())
    assert n_done > 0


def _jax_step_per_instance(jenv, bparams, state, actions, xi, eta):
    """JAX's batched step with auto-reset where every instance has its own
    params: the tree maps of batch.batched_step with the params vmapped."""
    s, ts = jax.vmap(jenv.step_xi)(bparams, state.env, actions, xi, eta)
    ep_ret = state.episode_return + ts.reward
    ep_len = state.episode_length + 1
    init = jax.vmap(jenv.reset)(bparams)
    sel = lambda new, old: jnp.where(  # noqa: E731
        ts.done.reshape(ts.done.shape + (1,) * (new.ndim - 1)), old, new)
    s = jax.tree.map(sel, s, init)
    obs = sel(ts.obs, jax.vmap(jenv.get_obs)(bparams, init))
    return state.replace(env=s, episode_return=jnp.where(ts.done, 0.0, ep_ret),
                         episode_length=jnp.where(ts.done, 0, ep_len)), obs, ep_ret


@pytest.mark.parametrize("stack", [0, 3])
def test_per_instance_params_match_jax(stack):
    """Params with [B] fields (r, K, Tmax and the growth model per instance)
    through batched_reset and batched_step, plain and windowed."""
    rng = np.random.default_rng(5)
    per = {"r": rng.uniform(0.1, 0.6, B), "K": rng.uniform(0.8, 1.2, B),
           "Tmax": rng.integers(3, 9, B).astype(np.int32),
           "model_idx": rng.integers(0, 6, B).astype(np.int32)}
    jenv, jp = gft.make("fishing-mixture-v1", dtype=jnp.float64, sigma=0.1)
    tenv, tp = make("fishing-mixture-v1", dtype=torch.float64, sigma=0.1)
    if stack:
        jenv, tenv = j_stack(jenv, stack), stack_observations(tenv, stack)
    jbp = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,)), jp.replace(
        **{k: jnp.asarray(v) for k, v in per.items()}))
    tbp = tp.replace(**{k: torch.from_numpy(v) for k, v in per.items()})
    tstate = batched_reset(tenv, tbp, B)
    jstate = j_reset(jenv, jp, B).replace(env=jax.vmap(jenv.reset)(jbp))
    assert tstate.env.t.shape == (B,)
    for g, w in zip((tstate.env.stock, tstate.env.harvest), (jstate.env.stock,
                                                             jstate.env.harvest)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    n_done = 0
    for _ in range(20):
        a = rng.uniform(-1.0, -0.4, (B, 1))
        xi, eta = rng.standard_normal((2, B))
        jstate, jobs, jret = _jax_step_per_instance(jenv, jbp, jstate, jnp.asarray(a),
                                                    jnp.asarray(xi), jnp.asarray(eta))
        tstate, tts = batched_step(tenv, tbp, tstate, torch.from_numpy(a),
                                   torch.from_numpy(np.stack([xi, eta])))
        np.testing.assert_allclose(tts.obs.numpy(), np.asarray(jobs), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tts.episode_return.numpy(), np.asarray(jret), atol=ATOL,
                                   rtol=0)
        got = [tstate.env.stock, tstate.env.harvest, tstate.env.t] if not stack else [
            tstate.env.env.stock, tstate.env.env.harvest, tstate.env.env.t, tstate.env.window]
        for g, w in zip(got + [tstate.episode_return, tstate.episode_length],
                        _leaves(jstate)):
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)
        n_done += int(tts.done.sum())
    assert n_done > B   # the per-instance horizons end episodes at different steps


@pytest.mark.parametrize("form", ["off", "adam"])
def test_train_step_on_the_stacked_env_matches_jax(form):
    """One PPO train step on stack_observations(fishing-may-obs-v1, 4) (obs
    windows of 4, so the packed samples have 9 fields and pad to 16 rows in
    the fused form) from the same weights and JAX's draws."""
    pair = _step_pair("gaussian", form, env_id="fishing-may-obs-v1", stack=4)
    assert pair[1][0].model.pi_d1.weight.shape[1] == 4
    _assert_steps_agree(pair)


@pytest.mark.parametrize("form", ["update", "adam"])
def test_fused_train_step_on_a_window_of_6_matches_jax(form):
    """One PPO train step with fused_update=True on stack_observations(
    fishing-v1, 6) (11 fields in 16 packed rows, beyond the 4 observation
    fields the CUDA kernel once took) from the same weights and JAX's own
    draws and tile permutations."""
    pair = _step_pair("gaussian", form, env_id="fishing-v1", stack=6)
    assert pair[1][0].model.pi_d1.weight.shape[1] == 6
    _assert_steps_agree(pair)
