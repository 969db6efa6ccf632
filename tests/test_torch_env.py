"""The port's env core against the JAX engine and the NumPy oracle.

`Env.step_xi` of the port, the JAX `Env.step_xi` and `oracle.rollout_xi` all
consume the same injected N(0,1) stream, made with numpy, and must agree in
float64 at atol 1e-12 (the bar of tests/test_exactness.py) across every
growth model × decode scheme × noise form, including the May model at its
tipping point, and over 50 seeded random configurations, where the C oracle
joins them. Also: the registry (ids, default params, override split), the
decode/encode tie rules and the spaces.
"""

import dataclasses
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_fishing_tpu as gft
import gym_fishing_tpu_torch as gtt
from gym_fishing_tpu.core.types import GROWTH_MODELS
from gym_fishing_tpu.oracle import oracle as orc
from gym_fishing_tpu.spaces import scaling as jscaling
from gym_fishing_tpu_torch.spaces import Box, Discrete
from gym_fishing_tpu_torch.spaces import scaling as tscaling

# the port's entry points default to the card; these tests run on the CPU
make = functools.partial(gtt.make, device="cpu")

torch.set_num_threads(1)

ATOL64 = 1e-12


def port_env(cfg):
    env = gtt.make_env("exactness", growth=cfg.growth, noise_form=cfg.noise_form,
                       scheme=cfg.scheme, n_actions=cfg.n_actions)
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(gtt.EnvParams)}
    return env, gtt.EnvParams(**fields).astype(torch.float64)


def jax_env(cfg):
    env = gft.make_env("exactness", growth=cfg.growth, noise_form=cfg.noise_form,
                       scheme=cfg.scheme, n_actions=cfg.n_actions)
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(gft.EnvParams)}
    return env, gft.EnvParams(**fields).astype(jnp.float64)


def run_port(cfg, actions, xis, etas):
    env, params = port_env(cfg)
    state = env.reset(params)
    out = []
    for a, xi, eta in zip(actions, xis, etas):
        dtype = torch.float64 if cfg.scheme == "continuous" else torch.int32
        state, ts = env.step_xi(params, state, torch.as_tensor(a, dtype=dtype), xi, eta)
        out.append((float(state.stock), float(ts.obs[0]), float(ts.reward), bool(ts.done),
                    float(ts.harvest), float(ts.quota), float(state.harvest)))
    return np.asarray(out)


def run_jax(cfg, actions, xis, etas):
    env, params = jax_env(cfg)
    state = env.reset(params)
    step = jax.jit(env.step_xi)
    out = []
    for a, xi, eta in zip(actions, xis, etas):
        dtype = jnp.float64 if cfg.scheme == "continuous" else jnp.int32
        state, ts = step(params, state, jnp.asarray(a, dtype), jnp.float64(xi), jnp.float64(eta))
        out.append((float(state.stock), float(ts.obs[0]), float(ts.reward), bool(ts.done),
                    float(ts.harvest), float(ts.quota), float(state.harvest)))
    return np.asarray(out)


def compare(cfg, actions, xis, etas):
    port = run_port(cfg, actions, xis, etas)
    jx = run_jax(cfg, actions, xis, etas)
    o = orc.rollout_xi(cfg, actions, xis, etas)
    np.testing.assert_allclose(port, jx, atol=ATOL64, rtol=0)
    for col, key in enumerate(("stock", "obs", "reward", "done", "harvest", "quota")):
        np.testing.assert_allclose(port[:, col], np.asarray(o[key], np.float64),
                                   atol=ATOL64, rtol=0, err_msg=key)
    return port


def make_streams(cfg, T, seed):
    rng = np.random.default_rng(seed)
    xis = rng.standard_normal(T)
    etas = rng.standard_normal(T)
    if cfg.scheme == "continuous":
        actions = [np.asarray([a]) for a in rng.uniform(-1.0, -0.4, T)]
    else:
        actions = list(rng.integers(0, cfg.n_actions, T))
    return actions, xis, etas


# ------------------------------------------------------ step_xi exactness


@pytest.mark.parametrize("growth", GROWTH_MODELS)
@pytest.mark.parametrize("noise_form", ["additive", "lognormal"])
def test_continuous_exactness(growth, noise_form):
    r = 3.0 if growth == "myers" else (0.75 if growth == "may" else 0.3)
    cfg = orc.OracleConfig(growth=growth, noise_form=noise_form, scheme="continuous",
                           sigma=0.08, r=r)
    actions, xis, etas = make_streams(cfg, 50, seed=zlib.crc32(f"{growth}/{noise_form}".encode()))
    compare(cfg, actions, xis, etas)


@pytest.mark.parametrize("scheme,n_actions", [("relative", 3), ("proportional", 100)])
def test_discrete_exactness(scheme, n_actions):
    cfg = orc.OracleConfig(growth="logistic", scheme=scheme, n_actions=n_actions, sigma=0.1)
    compare(cfg, *make_streams(cfg, 60, seed=7))


def test_obs_noise_exactness():
    cfg = orc.OracleConfig(growth="may", r=0.75, sigma=0.05, sigma_m=0.1)
    compare(cfg, *make_streams(cfg, 40, seed=11))


@pytest.mark.parametrize("x0", [0.29, 0.30, 0.31])
def test_may_near_unstable_equilibrium(x0):
    cfg = orc.OracleConfig(growth="may", r=0.75, sigma=0.0, init_state=x0, scheme="continuous")
    compare(cfg, [np.asarray([-1.0])] * 20, np.zeros(20), np.zeros(20))


@pytest.mark.parametrize("growth", ["ricker", "beverton_holt"])
def test_reward_shaping_exactness(growth):
    cfg = orc.OracleConfig(growth=growth, scheme="continuous", sigma=0.05, price=1.5, cost=0.3)
    compare(cfg, *make_streams(cfg, 50, seed=13))


@pytest.mark.parametrize("model_idx", range(len(GROWTH_MODELS)))
def test_mixture_exactness(model_idx):
    r = 3.0 if GROWTH_MODELS[model_idx] == "myers" else 0.3
    cfg = orc.OracleConfig(growth="mixture", model_idx=model_idx, r=r, sigma=0.05)
    compare(cfg, *make_streams(cfg, 30, seed=17 + model_idx))


def test_nonstationary_drift_exactness():
    cfg = orc.OracleConfig(growth="logistic", r_drift=-0.002, sigma=0.05)
    compare(cfg, *make_streams(cfg, 60, seed=11))


def test_collapse_penalty_exactness():
    cfg = orc.OracleConfig(sigma=0.0, collapse_penalty=2.5, Tmax=5)
    out = compare(cfg, [np.asarray([1.0])] * 3, np.zeros(3), np.zeros(3))
    assert out[0, 3] == 1.0 and out[0, 2] == pytest.approx(0.75 - 2.5, abs=1e-12)


def test_seeded_step_is_deterministic_per_generator():
    env, params = make("fishing-may-obs-v1", dtype=torch.float64)
    state = env.reset(params)
    a = torch.tensor([-0.5], dtype=torch.float64)
    s1, t1 = env.step(params, state, a, torch.Generator().manual_seed(3))
    s2, t2 = env.step(params, state, a, torch.Generator().manual_seed(3))
    s3, _ = env.step(params, state, a, torch.Generator().manual_seed(4))
    assert float(s1.stock) == float(s2.stock) and float(t1.obs[0]) == float(t2.obs[0])
    assert float(s1.stock) != float(s3.stock)


# --------------------------------------------------------------- registry


def test_registry_ids_match_jax():
    assert gtt.registered_ids() == gft.registered_ids()
    assert len(gtt.registered_ids()) == 26


@pytest.mark.parametrize("env_id", gft.registered_ids())
def test_registry_defaults_match_jax(env_id):
    jenv, jparams = gft.make(env_id, dtype=jnp.float64)
    tenv, tparams = make(env_id, dtype=torch.float64)
    assert dataclasses.asdict(tenv.config) == dataclasses.asdict(jenv.config)
    for f in dataclasses.fields(jparams):
        jv, tv = np.asarray(getattr(jparams, f.name)), getattr(tparams, f.name)
        assert tv.dtype == (torch.int32 if f.name in ("Tmax", "model_idx") else torch.float64)
        assert float(tv) == float(jv), f.name


@pytest.mark.parametrize("overrides", [
    {"n_actions": 10},
    {"n_actions": 10, "scheme": "relative"},
    {"n_actions": 3},
    {"growth": "ricker", "sigma": 0.2, "Tmax": 40},
    {"noise_form": "lognormal", "model_idx": 2.9},
])
def test_make_overrides_match_jax(overrides):
    jenv, jparams = gft.make("fishing-v0", dtype=jnp.float32, **overrides)
    tenv, tparams = make("fishing-v0", **overrides)
    assert dataclasses.asdict(tenv.config) == dataclasses.asdict(jenv.config)
    for f in dataclasses.fields(jparams):
        assert float(getattr(tparams, f.name)) == float(np.asarray(getattr(jparams, f.name)))


def test_make_rejects_unknown():
    with pytest.raises(TypeError, match="unknown override"):
        make("fishing-v1", bogus=1.0)
    with pytest.raises(ValueError, match="unknown env id"):
        make("fishing-v3")
    with pytest.raises(ValueError, match="already registered"):
        gtt.register("fishing-v1", gtt.EnvConfig())


@pytest.mark.parametrize("kw", [{"growth": "gompertz"}, {"noise_form": "uniform"},
                                {"scheme": "grid"}, {"n_actions": 1}])
def test_env_config_validation(kw):
    with pytest.raises(ValueError):
        gtt.EnvConfig(**kw)


# ------------------------------------------------------ decode and encode


@pytest.mark.parametrize("ratio", [0.5, 1.5, 2.5, 3.5, 2.4999999, 2.5000001])
def test_proportional_encode_rounds_half_to_even_like_jax(ratio):
    """quota * n / K at a tie rounds to the even action on both sides."""
    n = 8
    jenv, jp = gft.make("fishing-v0", dtype=jnp.float64, n_actions=n)
    tenv, tp = make("fishing-v0", dtype=torch.float64, n_actions=n)
    q = ratio / n  # K = 1
    ja = jscaling.encode_action(jenv.config, jp, jnp.float64(0.1), jnp.float64(q))
    ta = tscaling.encode_action(tenv.config, tp, torch.tensor(0.1, dtype=torch.float64),
                                torch.tensor(q, dtype=torch.float64))
    assert ta.dtype == torch.int32
    assert int(ta) == int(ja) == int(np.round(ratio))


@pytest.mark.parametrize("quota,expected", [(1.375, 0), (1.125, 0), (1.5, 1), (0.9, 2)])
def test_relative_encode_keeps_first_index_on_ties_like_jax(quota, expected):
    """h = 1.25 gives candidates 1.25, 1.5, 1.0 exactly; 1.375 and 1.125 are
    exact ties with candidate 0, which wins on both sides."""
    jenv, jp = gft.make("fishing-v0", dtype=jnp.float64)
    tenv, tp = make("fishing-v0", dtype=torch.float64)
    ja = jscaling.encode_action(jenv.config, jp, jnp.asarray([1.25]), jnp.asarray([quota]))
    ta = tscaling.encode_action(tenv.config, tp, torch.tensor([1.25], dtype=torch.float64),
                                torch.tensor([quota], dtype=torch.float64))
    assert int(ta[0]) == int(ja[0]) == expected


@pytest.mark.parametrize("env_id", ["fishing-v0", "fishing-v1"])
def test_env_utilities_match_jax(env_id):
    jenv, jp = gft.make(env_id, dtype=jnp.float64)
    tenv, tp = make(env_id, dtype=torch.float64)
    stocks = np.linspace(0.0, 2.5, 11)
    jstate = jenv.reset(jp).replace(stock=jnp.asarray(stocks),
                                    harvest=jnp.full(11, 0.05))
    tstate = tenv.reset(tp).replace(stock=torch.tensor(stocks),
                                    harvest=torch.full((11,), 0.05, dtype=torch.float64))
    np.testing.assert_array_equal(tenv.get_obs(tp, tstate).numpy(),
                                  np.asarray(jenv.get_obs(jp, jstate)))
    obs = np.linspace(-1, 1, 11)[:, None]
    np.testing.assert_array_equal(tenv.get_fish_population(tp, torch.tensor(obs)).numpy(),
                                  np.asarray(jenv.get_fish_population(jp, jnp.asarray(obs))))
    quotas = np.linspace(0.0, 0.3, 11)
    ta = tenv.get_action(tp, tstate, quotas)
    ja = jenv.get_action(jp, jstate, jnp.asarray(quotas))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tenv.get_quota(tp, tstate, ta).numpy(),
                                  np.asarray(jenv.get_quota(jp, jstate, ja)))


def test_spaces():
    tenv, _ = make("fishing-v1")
    g = torch.Generator().manual_seed(0)
    box = tenv.action_space
    assert isinstance(box, Box) and tenv.observation_space == Box(-1.0, 1.0, (1,))
    for _ in range(20):
        x = box.sample(g)
        assert x.shape == (1,) and x.dtype == torch.float32 and box.contains(x.numpy())
    disc = make("fishing-v0")[0].action_space
    assert disc == Discrete(3)
    draws = {int(disc.sample(g)) for _ in range(60)}
    assert draws == {0, 1, 2} and disc.contains(2) and not disc.contains(3)


# ------------------------------------------------ randomized-config fuzz


def fuzz_config(seed):
    """A seeded random configuration, in ranges where each model is
    well-behaved (no overflow), across models, schemes and noise forms."""
    rng = np.random.default_rng(seed)
    growth = (GROWTH_MODELS + ("mixture",))[seed % 7]
    scheme = ("continuous", "proportional", "relative")[rng.integers(3)]
    K = rng.uniform(0.5, 2.0)
    model = GROWTH_MODELS[rng.integers(6)] if growth == "mixture" else growth
    r = {"myers": rng.uniform(1.5, 3.5), "may": rng.uniform(0.5, 1.0)}.get(
        model, rng.uniform(0.1, 0.8))
    return orc.OracleConfig(
        growth=growth, scheme=scheme,
        noise_form=("additive", "lognormal")[rng.integers(2)],
        n_actions=3 if scheme == "relative" else int(rng.integers(4, 60)),
        r=r, r_drift=rng.choice([0.0, rng.uniform(-0.004, 0.004)]), K=K,
        sigma=rng.uniform(0.0, 0.2), sigma_m=rng.choice([0.0, rng.uniform(0.0, 0.2)]),
        price=rng.uniform(0.5, 2.0), cost=rng.choice([0.0, rng.uniform(0.0, 0.5)]),
        init_state=K * rng.uniform(0.2, 1.5), init_harvest=K * rng.uniform(0.005, 0.05),
        Tmax=int(rng.integers(5, 60)), action_scale=rng.uniform(0.5, 1.5),
        A=rng.uniform(1.1, 2.5), B=rng.uniform(0.2, 1.0), C=K * rng.uniform(0.05, 0.4),
        theta=rng.uniform(1.5, 3.0), a=rng.uniform(0.1, 0.3), b=rng.uniform(0.05, 0.3),
        q=rng.uniform(1.5, 3.0), model_idx=GROWTH_MODELS.index(model),
        collapse_penalty=rng.choice([0.0, rng.uniform(0.0, 3.0)]),
    )


@pytest.mark.parametrize("seed", range(50))
def test_randomized_config_fuzz(seed):
    """Port ≡ JAX ≡ NumPy oracle (compare) ≡ C oracle, T=50, float64."""
    from gym_fishing_tpu.native import COracle, available

    cfg = fuzz_config(seed)
    actions, xis, etas = make_streams(cfg, 50, seed=1000 + seed)
    port = compare(cfg, actions, xis, etas)
    if available():
        c = COracle(cfg).rollout_xi(actions, xis, etas)
        n = len(c["stock"])
        for col, key in enumerate(("stock", "obs", "reward", "done", "harvest", "quota")):
            np.testing.assert_allclose(port[:n, col], np.asarray(c[key], np.float64),
                                       atol=ATOL64, rtol=0, err_msg=f"C oracle {key}")
