"""The port's DP solver against the JAX solver (agents/dp.py), in float64.

Both build the MDP from the same params: the transition tensor P and the
rewards R agree within 1e-12 (the two packages' normal CDFs and operation
orders differ in the last bits), V within 1e-9 after thousands of sweeps.
The sweep count must be the same, unless the residual at JAX's last sweep
lies within 1e-12 (relative) of the stopping threshold, where the two may
differ by one. Greedy quotas must agree wherever JAX's best action leads
its runner-up by more than 1e-9.
"""

import dataclasses
import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_fishing_tpu as gft
import gym_fishing_tpu_torch as gtt
from gym_fishing_tpu.agents import escapement as j_escapement
from gym_fishing_tpu_torch.agents.policies import escapement

# the modules (each package's agents/__init__.py binds `dp` to the policy class)
jdp = importlib.import_module("gym_fishing_tpu.agents.dp")
dp = importlib.import_module("gym_fishing_tpu_torch.agents.dp")

make = functools.partial(gtt.make, dtype=torch.float64, device="cpu")

torch.set_num_threads(1)


def _pair(env_id="fishing-v1", lognormal=False, **overrides):
    jenv, jparams = gft.make(env_id, dtype=jnp.float64, **overrides)
    env, params = make(env_id, **overrides)
    if lognormal:
        jenv = dataclasses.replace(jenv, config=dataclasses.replace(jenv.config,
                                                                    noise_form="lognormal"))
        env = dataclasses.replace(env, config=dataclasses.replace(env.config,
                                                                  noise_form="lognormal"))
    return (jenv, jparams), (env, params)


def _assert_close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("env_id,lognormal,overrides", [
    ("fishing-v1", False, dict(sigma=0.1)),
    ("fishing-v1", True, dict(sigma=0.1)),
    ("fishing-v1", False, dict(sigma=0.0)),      # the delta rows
    ("fishing-may-v1", False, dict(sigma=0.05, collapse_penalty=1.0)),
    ("fishing-v1", False, dict(sigma=0.05, cost=0.3)),
])
def test_build_mdp_matches_jax(env_id, lognormal, overrides):
    (jenv, jparams), (env, params) = _pair(env_id, lognormal, **overrides)
    jm = jdp.build_mdp(jenv, jparams, n_states=65, n_quotas=17)
    m = dp.build_mdp(env, params, n_states=65, n_quotas=17)
    assert m.P.dtype == torch.float64 and m.P.shape == (17, 65, 65)
    for name in ("grid", "quotas", "P", "R"):
        _assert_close(getattr(m, name), getattr(jm, name), 1e-12)


def test_build_mdp_refuses_the_mixture():
    env, params = gtt.make("fishing-mixture-v1", device="cpu")
    with pytest.raises(ValueError, match="mixture"):
        dp.build_mdp(env, params)


def _assert_policies_agree(pol, j_sol, quotas):
    """The port's quota is JAX's, or within 1e-9 of its best in JAX's Q."""
    Q = np.asarray(j_sol.Q)
    idx = np.searchsorted(np.asarray(quotas), pol.numpy())
    got_q = np.take_along_axis(Q, idx[None, :], 0)[0]
    assert np.all(got_q >= Q.max(0) - 1e-9)
    same = pol.numpy() == np.asarray(j_sol.policy_quota)
    top2 = np.sort(Q, 0)[-2:]
    assert np.all(same | (top2[1] - top2[0] <= 1e-9))


def _assert_sweeps_agree(sol, j_sol, gamma, tol):
    stop = tol * (1.0 - gamma) / gamma
    if sol.iterations != int(j_sol.iterations):
        assert abs(sol.iterations - int(j_sol.iterations)) == 1
        assert abs(float(j_sol.residual) - stop) <= 1e-12 * stop


@pytest.mark.parametrize("env_id,overrides,gamma", [
    ("fishing-v1", dict(sigma=0.05), 0.99),
    ("fishing-v1", dict(sigma=0.0), 0.995),
    ("fishing-may-v1", dict(sigma=0.0), 0.99),
])
def test_value_iteration_matches_jax(env_id, overrides, gamma):
    (jenv, jparams), (env, params) = _pair(env_id, **overrides)
    kw = dict(gamma=gamma, n_states=65, n_quotas=33)
    j_sol = jdp.value_iteration(jenv, jparams, **kw)
    sol = dp.value_iteration(env, params, **kw)
    _assert_close(sol.V, j_sol.V, 1e-9)
    _assert_close(sol.Q, j_sol.Q, 1e-9)
    _assert_sweeps_agree(sol, j_sol, gamma, 1e-6)
    assert sol.iterations > dp.SWEEP_BLOCK   # the stop lies past the first block
    np.testing.assert_allclose(float(sol.residual), float(j_sol.residual), rtol=1e-6)
    _assert_policies_agree(sol.policy_quota, j_sol, j_sol.quotas)
    assert float(sol.V[0]) == 0.0


def test_value_iteration_stops_at_max_iters():
    (jenv, jparams), (env, params) = _pair(sigma=0.05)
    kw = dict(gamma=0.99, n_states=33, n_quotas=9, max_iters=5)
    j_sol = jdp.value_iteration(jenv, jparams, **kw)
    sol = dp.value_iteration(env, params, **kw)
    assert sol.iterations == int(j_sol.iterations) == 5
    _assert_close(sol.V, j_sol.V, 1e-12)
    np.testing.assert_allclose(float(sol.residual), float(j_sol.residual), rtol=1e-9)


def test_value_iteration_refuses_gamma_one():
    env, params = make("fishing-v1")
    with pytest.raises(ValueError, match="finite_horizon"):
        dp.value_iteration(env, params, gamma=1.0, n_states=9, n_quotas=3)


@pytest.mark.parametrize("gamma", [1.0, 0.97])
def test_finite_horizon_matches_jax(gamma):
    (jenv, jparams), (env, params) = _pair(sigma=0.05)
    kw = dict(gamma=gamma, n_states=65, n_quotas=33, T=40)
    jV, jpol, jm = jdp.finite_horizon(jenv, jparams, **kw)
    V, pol, m = dp.finite_horizon(env, params, **kw)
    assert V.shape == (40, 65) and pol.shape == (40, 65)
    _assert_close(V, jV, 1e-9)
    np.testing.assert_array_equal(pol.numpy(), np.asarray(jpol))
    V_full, _, _ = dp.finite_horizon(env, params, n_states=17, n_quotas=9)
    assert V_full.shape[0] == int(params.Tmax)


def test_policy_evaluation_matches_jax():
    (jenv, jparams), (env, params) = _pair(sigma=0.05)
    kw = dict(gamma=0.99, n_states=65, n_quotas=33)
    jV, jm = jdp.policy_evaluation(jenv, j_escapement(jenv, jparams).quota, jparams, **kw)
    V, m = dp.policy_evaluation(env, escapement(env, params).quota, params, **kw)
    _assert_close(V, jV, 1e-9)
    # per-state quotas on the grid, snapped to the nearest level
    q = np.linspace(0.0, 0.4, 65)
    jV2, _ = jdp.policy_evaluation(jenv, jnp.asarray(q), jparams, mdp=jm, gamma=0.99)
    V2, _ = dp.policy_evaluation(env, torch.from_numpy(q), params, mdp=m, gamma=0.99)
    _assert_close(V2, jV2, 1e-9)
    with pytest.raises(ValueError, match="shape"):
        dp.policy_evaluation(env, torch.zeros(3, dtype=torch.float64), params, mdp=m)


def test_dp_predict_matches_jax():
    (jenv, jparams), (env, params) = _pair(sigma=0.05)
    kw = dict(gamma=0.99, n_states=65, n_quotas=33)
    j_pol, pol = jdp.dp(jenv, jparams, **kw), dp.dp(env, params, **kw)
    obs = np.linspace(-1.0, 1.0, 41)[:, None]
    a, st = pol.predict(obs)
    j_a, _ = j_pol.predict(obs)
    assert a.shape == (41, 1) and st is None
    np.testing.assert_allclose(a, np.asarray(j_a), rtol=0, atol=1e-9)
    stock = torch.tensor([-0.5, 0.0, 0.3, 1.0, 2.0, 9.0], dtype=torch.float64)
    np.testing.assert_allclose(pol.quota(stock).numpy(),
                               np.asarray(j_pol.quota(jnp.asarray(stock.numpy()))), atol=1e-12)
