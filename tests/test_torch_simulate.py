"""The port's evaluation API (analysis/simulate.py, analysis/plotting.py)
against the JAX package.

- At sigma 0 the trajectory is noise-free: `simulate_mdp` equals JAX's frame.
- With noise, the device path's tensor part (`_simulate_steps`) gets JAX's
  own per-step draws (`normal(k, (2, reps))` for k in `split(key(seed),
  Tmax)`) and matches JAX's frame in float64 at atol 1e-12.
- The device path (pure `act`) and the host `.predict` loop draw the same
  stream and agree (the bar of tests/test_agents_analysis.py, 1e-6).
- `estimate_policyfn` conditions the relative scheme on the carried harvest.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_fishing_tpu as gft
import gym_fishing_tpu_torch as gtt
from gym_fishing_tpu.agents import policies as jpol
from gym_fishing_tpu.analysis import simulate as jsim
from gym_fishing_tpu_torch.agents import policies as tpol
from gym_fishing_tpu_torch.agents import ppo
from gym_fishing_tpu_torch.analysis import simulate as tsim
from gym_fishing_tpu_torch.analysis.plotting import plot_mdp, plot_policyfn, write_csv
from gym_fishing_tpu_torch.envs.wrappers import stack_observations

# the port's entry points default to the card; these tests run on the CPU
make = functools.partial(gtt.make, device="cpu")

torch.set_num_threads(1)

COLUMNS = ["time", "state", "action", "reward", "rep"]


def _pair(env_id, dtype="float32", **overrides):
    jenv, jp = gft.make(env_id, dtype=getattr(jnp, dtype), **overrides)
    tenv, tp = make(env_id, dtype=getattr(torch, dtype), **overrides)
    return jenv, jp, tenv, tp


def _assert_frames(got, want, atol):
    assert list(got.columns) == list(want.columns) == COLUMNS
    for col in ("time", "rep"):
        np.testing.assert_array_equal(got[col].to_numpy(), want[col].to_numpy())
    for col in ("state", "action", "reward"):
        np.testing.assert_allclose(got[col].to_numpy(), want[col].to_numpy(), atol=atol, rtol=0,
                                   err_msg=col)


@pytest.mark.parametrize("policy", ["escapement", "msy"])
@pytest.mark.parametrize("env_id", ["fishing-v1", "fishing-v0", "fishing-ricker-v1"])
def test_simulate_mdp_at_sigma_0_equals_jax(env_id, policy):
    jenv, jp, tenv, tp = _pair(env_id, sigma=0.0, Tmax=40)
    want = jsim.simulate_mdp(jenv, getattr(jpol, policy)(jenv, jp), reps=3, params=jp)
    got = tsim.simulate_mdp(tenv, getattr(tpol, policy)(tenv, tp), reps=3, params=tp)
    _assert_frames(got, want, atol=1e-6)
    assert got.action.dtype == want.action.dtype


@pytest.mark.parametrize("env_id", ["fishing-v1", "fishing-v0", "fishing-may-obs-v1"])
def test_device_path_with_jax_draws_matches_jax_in_float64(env_id):
    reps, seed = 16, 3
    jenv, jp, tenv, tp = _pair(env_id, "float64", sigma=0.1, Tmax=30)
    want = jsim.simulate_mdp(jenv, jpol.escapement(jenv, jp), reps=reps, params=jp, seed=seed)
    draws = np.stack([np.asarray(jax.random.normal(k, (2, reps), jnp.float64))
                      for k in jax.random.split(jax.random.key(seed), 30)])
    obs, actions, rewards = tsim._simulate_steps(tenv, tpol.escapement(tenv, tp), reps, tp, 30,
                                                 torch.from_numpy(draws))
    assert obs.shape == (30, reps, 1) and rewards.shape == (30, reps)
    got = tsim._traj_to_df(tenv, tp, obs, actions, rewards, 30, reps)
    _assert_frames(got, want, atol=1e-12)


@pytest.mark.parametrize("env_id", ["fishing-v1", "fishing-v0"])
def test_device_and_host_paths_agree(env_id):
    """With noise: the host loop steps the same batch from the same stream."""
    env, params = make(env_id, sigma=0.05)
    pol = tpol.escapement(env, params)

    class HostOnly:
        def predict(self, obs, state=None, **kw):
            return pol.predict(obs, state)

    fused = tsim.simulate_mdp(env, pol, reps=5, params=params, seed=5)
    host = tsim.simulate_mdp(env, HostOnly(), reps=5, params=params, seed=5)
    _assert_frames(fused, host, atol=1e-6)
    assert fused.state.std() > 0


def test_estimate_policyfn_carries_the_harvest_under_the_relative_scheme():
    jenv, jp, tenv, tp = _pair("fishing-v0", sigma=0.0)
    for harvest in (None, 0.02, 0.3):
        want = jsim.estimate_policyfn(jenv, jpol.escapement(jenv, jp), reps=2, n=30, params=jp,
                                      harvest=harvest)
        got = tsim.estimate_policyfn(tenv, tpol.escapement(tenv, tp), reps=2, n=30, params=tp,
                                     harvest=harvest)
        assert list(got.columns) == ["state", "action", "rep"]
        np.testing.assert_allclose(got.state.to_numpy(), want.state.to_numpy(), rtol=1e-12)
        np.testing.assert_array_equal(got.action.to_numpy(), want.action.to_numpy())
    low = tsim.estimate_policyfn(tenv, tpol.escapement(tenv, tp), n=30, params=tp, harvest=0.02)
    high = tsim.estimate_policyfn(tenv, tpol.escapement(tenv, tp), n=30, params=tp, harvest=0.3)
    assert (low.action != high.action).any()


def test_estimate_policyfn_continuous_matches_jax():
    jenv, jp, tenv, tp = _pair("fishing-v1")
    want = jsim.estimate_policyfn(jenv, jpol.msy(jenv, jp), reps=1, n=25, params=jp)
    got = tsim.estimate_policyfn(tenv, tpol.msy(tenv, tp), reps=1, n=25, params=tp)
    np.testing.assert_allclose(got.action.to_numpy(), want.action.to_numpy(), atol=1e-6)


def test_simulate_a_ppo_policy_on_the_stacked_env():
    """A PPOPolicy over windows of 4 takes the device path; the frame's state
    is the newest window entry's stock."""
    env, params = make("fishing-may-obs-v1")
    senv = stack_observations(env, 4)
    cfg = ppo.PPOConfig(hidden=32)
    ts = ppo.make_train_state(senv, cfg, torch.Generator().manual_seed(0), device="cpu")
    pol = ppo.PPOPolicy(senv, ts)
    df = tsim.simulate_mdp(senv, pol, reps=4, params=params, seed=1)
    assert len(df) == 4 * 100 and list(df.columns) == COLUMNS
    obs, actions, _ = tsim._simulate_steps(senv, pol, 4, params, 100,
                                          torch.Generator().manual_seed(1))
    assert obs.shape == (100, 4, 4) and actions.shape == (100, 4, 1)
    first = df[df.rep == 0].state.to_numpy()
    np.testing.assert_allclose(first, (params.K * (obs[:, 0, -1] + 1.0)).numpy(), rtol=1e-6)


def test_simulate_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env, params = make("fishing-v1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsim.simulate_mdp(env, tpol.msy(env, params), reps=2)
    df = tsim.simulate_mdp(env, tpol.msy(env, params), reps=2, device="cpu")
    assert df.rep.nunique() == 2


def test_plots_and_csv(tmp_path):
    env, params = make("fishing-v1", sigma=0.05)
    df = tsim.simulate_mdp(env, tpol.msy(env, params), reps=3, params=params)
    assert df.rep.nunique() == 3 and len(df) == 300
    plot_mdp(df, str(tmp_path / "mdp.png"))
    dfp = tsim.estimate_policyfn(env, tpol.msy(env, params), reps=2, n=20, params=params)
    plot_policyfn(dfp, str(tmp_path / "policy.png"))
    write_csv(df, str(tmp_path / "sim.csv"))
    for name in ("mdp.png", "policy.png", "sim.csv"):
        assert (tmp_path / name).stat().st_size > 0
    import pandas as pd

    back = pd.read_csv(tmp_path / "sim.csv")
    np.testing.assert_allclose(back.state.to_numpy(), df.state.to_numpy(), rtol=1e-6)
