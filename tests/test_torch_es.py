"""The port's ES learner against the JAX learner (agents/es.py).

Every comparison starts from the flax policy converted to the port and feeds
the port JAX's own draws, rebuilt from its key schedule: es_train_step
splits its key into (k_eps, k_eval); k_eps into one key per parameter leaf
(the flax tree's order), each drawing normal(k, (pop / 2, *leaf.shape));
k_eval into one key per member, each split into (k_reset, k_roll), k_roll
into one key per step, each drawing the env's normal(k, (2, E)). The port
steps all members as one batch, member-major. Fitness agrees within 1e-5
(float32 sums of up to Tmax rewards in another order), and so do the
parameters after one Adam step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_fishing_tpu as gft
import gym_fishing_tpu_torch as gtt
from gym_fishing_tpu.agents import es as jes
from gym_fishing_tpu_torch.agents import es
from gym_fishing_tpu_torch.convert import actor_critic_to_numpy, deterministic_policy_from_numpy

make = functools.partial(gtt.make, device="cpu")
from_numpy = functools.partial(deterministic_policy_from_numpy, device="cpu")

torch.set_num_threads(1)

ENV_IDS = {"gaussian": "fishing-v1", "categorical": "fishing-v0"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_name(path) -> str:
    """('params', 'd1', 'kernel') -> 'd1.weight'."""
    keys = [k.key for k in path][1:]
    return f"{keys[0]}.{'weight' if keys[1] == 'kernel' else 'bias'}"


def _jax_draws(key, ts, cfg, steps):
    """es_train_step(key)'s perturbations (port names and layout, first
    half) and env draws [steps, 2, pop * E], member-major."""
    k_eps, k_eval = jax.random.split(key)
    paths = jax.tree.leaves_with_path(ts.params)
    half = cfg.pop_size // 2
    eps = {}
    for (path, leaf), k in zip(paths, jax.random.split(k_eps, len(paths))):
        e = np.array(jax.random.normal(k, (half,) + leaf.shape, jnp.float32))
        eps[_port_name(path)] = torch.from_numpy(e.swapaxes(1, 2).copy() if e.ndim == 3 else e)
    members = []
    for k in jax.random.split(k_eval, cfg.pop_size):
        _, k_roll = jax.random.split(k)
        members.append(np.stack([np.asarray(jax.random.normal(s, (2, cfg.envs_per_member),
                                                              jnp.float32))
                                 for s in jax.random.split(k_roll, steps)]))
    noise = np.concatenate(members, axis=-1)      # [steps, 2, pop * E]
    return eps, torch.from_numpy(noise)


def _port_state(ts, continuous):
    model = from_numpy(_np(ts.params), continuous)
    zeros = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    return es.ESState(model=model, m=zeros, v={n: z.clone() for n, z in zeros.items()})


def test_centered_ranks_with_ties_match_jax():
    f = np.array([3.0, -1.0, 10.0, 0.5, 3.0, -1.0, -1.0, 7.0], np.float32)
    r = es._centered_ranks(torch.from_numpy(f)).numpy()
    np.testing.assert_array_equal(r, np.asarray(jes._centered_ranks(jnp.asarray(f))))
    assert r.min() == -0.5 and r.max() == 0.5
    # ties keep their order: the three -1.0 take ranks 0, 1, 2 left to right
    np.testing.assert_allclose(r[[1, 5, 6]], np.array([0, 1, 2]) / 7 - 0.5)
    rng = np.random.default_rng(0)
    g = rng.integers(0, 5, 257).astype(np.float32)     # mostly ties
    np.testing.assert_array_equal(es._centered_ranks(torch.from_numpy(g)).numpy(),
                                  np.asarray(jes._centered_ranks(jnp.asarray(g))))


@pytest.mark.parametrize("head", ["gaussian", "categorical"])
def test_episode_returns_match_jax(head):
    """Each member's mean first-episode return, the population as one batch
    of the engine, against JAX's per-member rollouts."""
    jenv, jparams = gft.make(ENV_IDS[head], sigma=0.1)
    cfg = jes.ESConfig(pop_size=8, envs_per_member=3, hidden=16)
    ts = jes.make_es_state(jenv, cfg, jax.random.key(1))
    steps, key = 30, jax.random.key(9)
    eps, noise = _jax_draws(key, ts, cfg, steps)
    k_eps, k_eval = jax.random.split(key)
    continuous = head == "gaussian"
    leaves, treedef = jax.tree.flatten(ts.params)
    j_eps = [jax.random.normal(k, (cfg.pop_size // 2,) + leaf.shape, jnp.float32)
             for k, leaf in zip(jax.random.split(k_eps, len(leaves)), leaves)]
    j_pop = jax.tree.unflatten(treedef, [p[None] + 0.5 * jnp.concatenate([e, -e])
                                         for p, e in zip(leaves, j_eps)])
    want = jax.vmap(lambda mp, k: jes._episode_returns(
        jenv, jparams, ts.apply_fn, mp, continuous, steps, cfg.envs_per_member, k))(
        j_pop, jax.random.split(k_eval, cfg.pop_size))

    env, params = make(ENV_IDS[head], sigma=0.1)
    model = from_numpy(_np(ts.params), continuous)
    pop = {n: p.detach()[None] + 0.5 * torch.cat([eps[n], -eps[n]])
           for n, p in model.named_parameters()}
    got = es._episode_returns(env, params, pop, continuous, steps, cfg.envs_per_member, noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert np.ptp(np.asarray(want)) > 0.1     # the members differ


@pytest.mark.parametrize("head,rank_shaping", [("gaussian", True), ("gaussian", False),
                                               ("categorical", True)])
def test_es_train_step_matches_jax(head, rank_shaping):
    jenv, jparams = gft.make(ENV_IDS[head], sigma=0.1)
    cfg = jes.ESConfig(pop_size=16, envs_per_member=2, hidden=16, sigma=0.1,
                       rank_shaping=rank_shaping)
    steps, key = 20, jax.random.key(5)
    ts0 = jes.make_es_state(jenv, cfg, jax.random.key(2))
    j_ts, j_met = jax.jit(lambda ts, k: jes.es_train_step(jenv, jparams, cfg, steps, ts, k))(
        ts0, key)
    eps, noise = _jax_draws(key, ts0, cfg, steps)
    env, params = make(ENV_IDS[head], sigma=0.1)
    state = _port_state(ts0, head == "gaussian")
    port_cfg = es.ESConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    state, met = es.es_train_step(env, params, port_cfg, steps, state, eps=eps, env_noise=noise)
    for name in ("fitness_mean", "fitness_max", "fitness_std"):
        np.testing.assert_allclose(float(met[name]), float(j_met[name]), rtol=0, atol=1e-5,
                                   err_msg=name)
    assert state.count == 1
    got = {jax.tree_util.keystr(k): v
           for k, v in jax.tree.leaves_with_path(actor_critic_to_numpy(state.model))}
    for k, want in jax.tree.leaves_with_path(_np(j_ts.params)):
        np.testing.assert_allclose(got[jax.tree_util.keystr(k)], want, rtol=0, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(k))


def test_es_pop_size_must_be_even():
    with pytest.raises(ValueError, match="even"):
        es.ESConfig(pop_size=7)


def test_es_train_and_policy_on_the_discrete_env():
    env, params = make("fishing-v0", sigma=0.05)
    cfg = es.ESConfig(pop_size=16, envs_per_member=2, episode_len=12)
    state, hist = es.es_train(env, cfg, seed=1, generations=2, env_params=params, device="cpu")
    assert len(hist) == 2 and np.isfinite(hist[-1]["fitness_mean"]) and state.count == 2
    a, st = es.ESPolicy(env, state).predict(np.zeros((1,), np.float32))
    assert a.dtype == np.int32 and st is None


def test_es_train_step_is_deterministic():
    env, params = make("fishing-v1", sigma=0.1)
    cfg = es.ESConfig(pop_size=8, envs_per_member=1, episode_len=10)
    outs = []
    for _ in range(2):
        state = es.make_es_state(env, cfg, torch.Generator().manual_seed(3), device="cpu")
        state, met = es.es_train_step(env, params, cfg, 10, state, torch.Generator().manual_seed(4))
        outs.append((state, met))
    for p, q in zip(outs[0][0].model.parameters(), outs[1][0].model.parameters()):
        assert torch.equal(p, q)
    assert float(outs[0][1]["fitness_mean"]) == float(outs[1][1]["fitness_mean"])
