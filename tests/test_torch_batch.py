"""The port's batched engine and baseline policies against the JAX package.

`batched_step` with auto-reset is fed the very (2, B) noise plane that JAX's
`batched_step` draws (`jax.random.normal(key, (2, B))`), and both must agree
at every step: state, obs (including done envs' noise-free reset obs),
reward, done and the finished episodes' return and length. float64 at
atol 1e-12; float32 at 1e-6. The escapement/msy policies must give the
same x*, MSY harvest and actions.
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
from gym_fishing_tpu.agents import policies as jpol
from gym_fishing_tpu.batch import batched_reset as j_reset
from gym_fishing_tpu.batch import batched_step as j_step
from gym_fishing_tpu_torch.agents import policies as tpol
from gym_fishing_tpu_torch.batch import batched_reset, batched_step, batched_step_xi, rollout
from gym_fishing_tpu_torch.convert import batch_state_from_numpy, params_from_numpy

# the port's entry points default to the card; these tests run on the CPU
make = functools.partial(gtt.make, device="cpu")
batch_state_from_numpy = functools.partial(batch_state_from_numpy, device="cpu")

torch.set_num_threads(1)

B = 64
FIELDS = ("obs", "reward", "done", "collapsed", "quota", "harvest", "episode_return",
          "episode_length")


def jax_fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def flat_state(bs):
    """A BatchState of either package as the flat numpy mapping of
    convert.batch_state_from_numpy."""
    return {"stock": np.asarray(bs.env.stock), "harvest": np.asarray(bs.env.harvest),
            "t": np.asarray(bs.env.t), "episode_return": np.asarray(bs.episode_return),
            "episode_length": np.asarray(bs.episode_length)}


@pytest.mark.parametrize("dtype,atol", [("float64", 1e-12), ("float32", 1e-6)])
@pytest.mark.parametrize("env_id,overrides", [
    ("fishing-v1", {"sigma": 0.1, "Tmax": 7}),
    ("fishing-v0", {"sigma": 0.1, "Tmax": 9}),
    ("fishing-v0", {"sigma": 0.1, "Tmax": 9, "n_actions": 10}),
    ("fishing-may-obs-v1", {"sigma": 0.05, "sigma_m": 0.2, "Tmax": 11}),
    ("fishing-mixture-v1", {"sigma": 0.1, "model_idx": 4, "Tmax": 8, "collapse_penalty": 1.5}),
])
def test_batched_step_autoreset_matches_jax(env_id, overrides, dtype, atol):
    jenv, jp = gft.make(env_id, dtype=getattr(jnp, dtype), **overrides)
    tenv, tp = make(env_id, dtype=getattr(torch, dtype), **overrides)
    jstate = j_reset(jenv, jp, B)
    tstate = batched_reset(tenv, tp, B)
    rng = np.random.default_rng(0)
    step = jax.jit(j_step, static_argnums=(0,))
    key = jax.random.key(1)
    for k in range(30):
        if tenv.config.scheme == "continuous":
            a = rng.uniform(-1.0, -0.5, (B, 1))
            a[rng.random(B) < 0.05] = 1.0  # harvest everything: collapse + reset
            ja, ta = jnp.asarray(a, jp.dtype), torch.tensor(a, dtype=tp.dtype)
        else:
            a = rng.integers(0, tenv.config.n_actions, B).astype(np.int32)
            ja, ta = jnp.asarray(a), torch.from_numpy(a)
        key, sub = jax.random.split(key)
        noise = np.array(jax.random.normal(sub, (2, B), jp.dtype))
        jstate, jts = step(jenv, jp, jstate, ja, sub)
        tstate, tts = batched_step(tenv, tp, tstate, ta, torch.from_numpy(noise))
        for name in FIELDS:
            np.testing.assert_allclose(getattr(tts, name).numpy(), np.asarray(getattr(jts, name)),
                                       atol=atol, rtol=0, err_msg=f"step {k}: {name}")
        got = flat_state(tstate)
        for name, ref in flat_state(jstate).items():
            np.testing.assert_allclose(got[name], ref, atol=atol, rtol=0,
                                       err_msg=f"step {k}: state {name}")
    assert tts.episode_length.dtype == torch.int32


def test_batched_step_resumes_from_converted_jax_state():
    """A JAX BatchState carried across with convert.batch_state_from_numpy
    steps on identically."""
    jenv, jp = gft.make("fishing-v1", dtype=jnp.float64, sigma=0.1, Tmax=5)
    tenv, _ = make("fishing-v1", dtype=torch.float64, sigma=0.1, Tmax=5)
    tp = params_from_numpy(jax_fields(jp), torch.float64, "cpu")
    jstate = j_reset(jenv, jp, B)
    key = jax.random.key(2)
    a = jnp.full((B, 1), -0.8, jnp.float64)
    for _ in range(3):
        key, sub = jax.random.split(key)
        jstate, _ = j_step(jenv, jp, jstate, a, sub)
    tstate = batch_state_from_numpy(flat_state(jstate), torch.float64)
    assert tstate.env.t.dtype == torch.int32 and tstate.episode_length.dtype == torch.int32
    key, sub = jax.random.split(key)
    noise = torch.from_numpy(np.array(jax.random.normal(sub, (2, B), jnp.float64)))
    jstate, jts = j_step(jenv, jp, jstate, a, sub)
    tstate, tts = batched_step(tenv, tp, tstate, torch.from_numpy(np.array(a)), noise)
    np.testing.assert_allclose(tstate.env.stock.numpy(), np.asarray(jstate.env.stock),
                               atol=1e-12)
    np.testing.assert_allclose(tts.episode_return.numpy(), np.asarray(jts.episode_return),
                               atol=1e-12)


def test_batched_reset_matches_jax():
    jenv, jp = gft.make("fishing-v0", dtype=jnp.float64)
    tenv, tp = make("fishing-v0", dtype=torch.float64)
    js, ts = j_reset(jenv, jp, 5), batched_reset(tenv, tp, 5)
    got = flat_state(ts)
    for name, ref in flat_state(js).items():
        assert got[name].shape == (5,) and got[name].dtype == ref.dtype
        np.testing.assert_array_equal(got[name], ref)


def test_batched_step_xi_equals_independent_singles():
    env, params = make("fishing-v1", dtype=torch.float64, sigma=0.1)
    rng = np.random.default_rng(0)
    state = batched_reset(env, params, 16).env
    state = state.replace(stock=torch.tensor(rng.uniform(0.2, 1.5, 16)))
    actions = torch.tensor(rng.uniform(-1, 0, (16, 1)))
    xi, eta = torch.tensor(rng.standard_normal(16)), torch.tensor(rng.standard_normal(16))
    bstate, bts = batched_step_xi(env, params, state, actions, xi, eta)
    for i in range(16):
        single = gtt.EnvState(stock=state.stock[i], harvest=state.harvest[i], t=state.t[i])
        ss, ts = env.step_xi(params, single, actions[i], xi[i], eta[i])
        assert float(ss.stock) == float(bstate.stock[i])
        assert float(ts.reward) == float(bts.reward[i])
        assert float(ts.obs[0]) == float(bts.obs[i, 0])


def test_autoreset_resets_done_instances():
    env, params = make("fishing-v1", dtype=torch.float64, sigma=0.0, Tmax=5)
    state = batched_reset(env, params, 4)
    actions = torch.tensor([[1.0], [-1.0], [-1.0], [-1.0]], dtype=torch.float64)
    state, ts = batched_step(env, params, state, actions, torch.zeros(2, 4, dtype=torch.float64))
    assert bool(ts.done[0]) and not bool(ts.done[1])
    assert float(state.env.stock[0]) == float(params.init_state)
    assert float(ts.obs[0, 0]) == float(params.init_state / params.K - 1.0)
    assert int(state.env.t[0]) == 0 and int(state.env.t[1]) == 1
    assert float(state.episode_return[0]) == 0.0
    assert float(ts.episode_return[0]) == float(ts.reward[0])
    assert int(ts.episode_length[0]) == 1
    with pytest.raises(ValueError, match="noise must have shape"):
        batched_step(env, params, state, actions, torch.zeros(2, 3, dtype=torch.float64))


def test_rollout_shapes_and_generator_determinism():
    env, params = make("fishing-v2", sigma=0.05, Tmax=7)  # logistic + obs noise
    T = 10

    def policy(obs, gen):  # quota <= 0.05: sustainable, no collapse
        return -0.95 - 0.05 * torch.rand((16, 1), generator=gen)

    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(1)
        runs.append(rollout(env, params, policy, batched_reset(env, params, 16), gen, T))
    (fin, traj), (fin2, traj2) = runs
    assert traj.obs.shape == (T, 16, 1) and traj.action.shape == (T, 16, 1)
    assert traj.reward.shape == (T, 16) and traj.done.dtype == torch.bool
    assert bool((traj.obs >= -1).all() and (traj.obs <= 1).all())
    assert bool(traj.done[6].all())  # Tmax = 7, no collapse at these quotas
    torch.testing.assert_close(traj.reward, traj2.reward, rtol=0, atol=0)
    torch.testing.assert_close(fin.env.stock, fin2.env.stock, rtol=0, atol=0)


# ---------------------------------------------------------------- policies


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("env_id", ["fishing-v0", "fishing-v1", "fishing-ricker-v1",
                                    "fishing-beverton-holt-v1", "fishing-allen-v1",
                                    "fishing-myers-v1", "fishing-may-v1", "fishing-mixture-v0"])
def test_policies_match_jax(env_id, dtype):
    jenv, jp = gft.make(env_id, dtype=getattr(jnp, dtype))
    tenv, tp = make(env_id, dtype=getattr(torch, dtype))
    # The grid and its argmax agree exactly; the surplus there goes through
    # each library's exp/pow, which may differ in the last ulp.
    rtol = 1e-12 if dtype == "float64" else 1e-6
    obs = np.linspace(-1.0, 1.0, 33)[:, None].astype(dtype)
    for name in ("escapement", "msy"):
        jp_, tp_ = getattr(jpol, name)(jenv, jp), getattr(tpol, name)(tenv, tp)
        assert float(tp_.x_star) == float(jp_.x_star)
        assert float(tp_.msy_harvest) == pytest.approx(float(jp_.msy_harvest), rel=rtol)
        np.testing.assert_allclose(tp_.act(torch.from_numpy(obs)).numpy(),
                                   np.asarray(jp_.act(jnp.asarray(obs))), rtol=rtol, atol=0)
        ta, tstate = tp_.predict(obs)
        ja, jstate = jp_.predict(obs)
        np.testing.assert_allclose(ta, ja, rtol=rtol, atol=0)
        if tenv.config.scheme == "relative":
            np.testing.assert_allclose(tstate, jstate, rtol=rtol, atol=0)
            ta2, _ = tp_.predict(obs, state=tstate)
            ja2, _ = jp_.predict(obs, state=jstate)
            np.testing.assert_array_equal(ta2, ja2)
        else:
            assert tstate is None and jstate is None


def test_logistic_msy_is_closed_form():
    env, params = make("fishing-v1", dtype=torch.float64)
    x_star, msy_h = tpol.surplus_production_msy(env, params)
    assert float(x_star) == 0.5 and float(msy_h) == pytest.approx(0.075, abs=1e-12)


def test_user_action_prompts_for_a_quota(monkeypatch):
    env, params = make("fishing-v1")
    monkeypatch.setattr("builtins.input", lambda prompt: "0.25")
    action, state = tpol.user_action(env, params).predict(np.zeros((1, 1), np.float32))
    assert state is None
    np.testing.assert_allclose(action, [[-0.75]])
