"""The port's model-uncertainty engine (batch/randomized.py) against the JAX
package and against its own batched engine.

- Degenerate ranges (lo = hi): every draw is the default, so
  `randomized_step` fed JAX's own noise plane of each step (the first half
  of `split(key)`) equals JAX's `randomized_step` in float64 at atol 1e-12,
  collapses and resets included, and equals the port's `batched_step` from
  the same noise exactly.
- Full ranges: every growth model is drawn, each field within its range, the
  integer fields over U{lo..hi} inclusive, and done instances get fresh
  params in the step that ends their episode.
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
from gym_fishing_tpu.batch import randomized as jrand
from gym_fishing_tpu_torch.batch import batched_reset, batched_step
from gym_fishing_tpu_torch.batch import randomized as trand
from gym_fishing_tpu_torch.envs.wrappers import stack_observations

# the port's entry points default to the card; these tests run on the CPU
make = functools.partial(gtt.make, device="cpu")

torch.set_num_threads(1)

B = 64
# the ranges of examples/model_uncertainty.py, and an integer horizon
RANGES = {"model_idx": (0, 5), "r": (0.2, 1.0), "K": (0.7, 1.3), "sigma": (0.0, 0.1),
          "Tmax": (50, 150)}
FIELDS = ("obs", "reward", "done", "collapsed", "quota", "harvest", "episode_return",
          "episode_length")


def _degenerate(params):
    return {k: (float(getattr(params, k)),) * 2 for k in RANGES}


def _actions(rng):
    a = rng.uniform(-1.0, -0.4, (B, 1))
    a[rng.random(B) < 0.05] = 1.0   # harvest everything: collapse + fresh params
    return a


def test_degenerate_ranges_match_jax_in_float64():
    jenv, jp = gft.make("fishing-mixture-v1", dtype=jnp.float64, model_idx=2, Tmax=12)
    tenv, tp = make("fishing-mixture-v1", dtype=torch.float64, model_idx=2, Tmax=12)
    j_sample = jrand.make_param_sampler(jp, _degenerate(jp))
    t_sample = trand.make_param_sampler(tp, _degenerate(tp))
    jstate, jbp = jrand.randomized_reset(jenv, j_sample, B, jax.random.key(0))
    tstate, tbp = trand.randomized_reset(tenv, t_sample, B, torch.Generator().manual_seed(0))
    for f in dataclasses.fields(tbp):
        np.testing.assert_array_equal(getattr(tbp, f.name).numpy(),
                                      np.asarray(getattr(jbp, f.name)), err_msg=f.name)
    step = jax.jit(jrand.randomized_step, static_argnums=(0, 1))
    rng, key, n_done = np.random.default_rng(1), jax.random.key(2), 0
    gen = torch.Generator().manual_seed(3)
    for _ in range(30):
        a = _actions(rng)
        key, sub = jax.random.split(key)
        noise = np.array(jax.random.normal(jax.random.split(sub)[0], (2, B), jnp.float64))
        jstate, jbp, jout = step(jenv, j_sample, jbp, jstate, jnp.asarray(a), sub)
        tstate, tbp, tout = trand.randomized_step(tenv, t_sample, tbp, tstate,
                                                  torch.from_numpy(a), torch.from_numpy(noise),
                                                  gen)
        for name in FIELDS:
            np.testing.assert_allclose(getattr(tout, name).numpy(),
                                       np.asarray(getattr(jout, name)), atol=1e-12, rtol=0,
                                       err_msg=name)
        for got, want in ((tstate.env.stock, jstate.env.stock), (tstate.env.t, jstate.env.t),
                          (tstate.env.harvest, jstate.env.harvest),
                          (tstate.episode_return, jstate.episode_return)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12, rtol=0)
        n_done += int(tout.done.sum())
    assert n_done > B


@pytest.mark.parametrize("stack", [0, 2])
def test_degenerate_ranges_equal_batched_step(stack):
    """lo = hi: the randomized engine is `batched_step` with auto-reset, bit
    for bit (the env has no measurement noise, so the noise-free obs that
    every instance sees is the step's own)."""
    env, params = make("fishing-mixture-v1", model_idx=3, sigma=0.1, Tmax=9)
    if stack:
        env = stack_observations(env, stack)
    sample = trand.make_param_sampler(params, _degenerate(params))
    rstate, bp = trand.randomized_reset(env, sample, B, torch.Generator().manual_seed(0))
    bstate = batched_reset(env, params, B)
    rng, gen = np.random.default_rng(4), torch.Generator().manual_seed(5)
    for _ in range(25):
        a = torch.from_numpy(_actions(rng).astype(np.float32))
        noise = torch.randn((2, B), generator=gen)
        rstate, bp, rout = trand.randomized_step(env, sample, bp, rstate, a, noise, gen)
        bstate, bout = batched_step(env, params, bstate, a, noise)
        for name in FIELDS:
            assert torch.equal(getattr(rout, name), getattr(bout, name)), name
        assert torch.equal(rstate.episode_return, bstate.episode_return)


def test_full_ranges_draw_every_model_within_range():
    env, params = make("fishing-mixture-v1")
    sample = trand.make_param_sampler(params, RANGES)
    n = 6000
    bp = sample(torch.Generator().manual_seed(0), n)
    counts = np.bincount(bp.model_idx.numpy(), minlength=6)
    assert len(counts) == 6
    share, sd = 1 / 6, np.sqrt((1 / 6) * (5 / 6) / n)
    assert np.all(np.abs(counts / n - share) <= 5 * sd), counts
    for name, (lo, hi) in RANGES.items():
        v = getattr(bp, name).double().numpy()
        assert v.shape == (n,) and v.min() >= lo and v.max() <= hi, name
    assert bp.Tmax.dtype == bp.model_idx.dtype == torch.int32
    assert bp.Tmax.min() == 50 and bp.Tmax.max() == 150
    # the fields outside the ranges keep the base params, per instance
    assert bool((bp.price == params.price).all()) and bp.price.shape == (n,)


def test_randomized_rollout_resamples_done_instances():
    env, params = make("fishing-mixture-v1")
    ranges = dict(RANGES, Tmax=(3, 6))
    sample = trand.make_param_sampler(params, ranges)
    gen = torch.Generator().manual_seed(7)
    state, bp = trand.randomized_reset(env, sample, B, gen)
    before = bp
    state, bp, traj = trand.randomized_rollout(
        env, sample, lambda obs, g: torch.full(obs.shape, -0.5), state, bp, gen, 12)
    assert traj.obs.shape == (12, B, 1) and traj.action.shape == (12, B, 1)
    assert traj.reward.shape == traj.done.shape == (12, B)
    assert bool(traj.done.any(0).all())   # every instance ended an episode
    changed = (bp.r != before.r) | (bp.K != before.K)
    assert bool(changed.all())
    for name, (lo, hi) in ranges.items():
        v = getattr(bp, name).double()
        assert bool((v >= lo).all() and (v <= hi).all()), name
    assert bool(torch.isfinite(traj.reward).all())


def test_sampler_and_step_refuse_bad_input():
    env, params = make("fishing-v1")
    with pytest.raises(TypeError, match="unknown EnvParams"):
        trand.make_param_sampler(params, {"rr": (0.1, 0.2)})
    sample = trand.make_param_sampler(params, {"r": (0.1, 0.2)})
    state, bp = trand.randomized_reset(env, sample, 8, torch.Generator())
    with pytest.raises(ValueError, match="noise must have shape"):
        trand.randomized_step(env, sample, bp, state, torch.zeros(8, 1), torch.zeros(2, 7))
