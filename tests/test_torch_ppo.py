"""The port's PPO learner against the JAX learner (agents/ppo.py).

Every comparison starts from weights converted from the flax tree (flax and
torch orthogonal inits differ) and feeds the port JAX's own random draws,
rebuilt from its key schedule: train_step splits its key into (k_roll,
k_perm); the rollout splits k_roll into one key per step and each step key
into (k_act, k_env); actions draw normal(k_act, mean.shape) or, for the
categorical head, Gumbel-max over gumbel(k_act, logits.shape); the env draws
normal(k_env, (2, B)); the plain update permutes N samples with
permutation(k, N) for k in split(k_perm, epochs), the fused forms permute
the tiles. Tolerances are float32 ones: the two frameworks sum in different
orders, and Adam's first steps move each weight by about lr whatever the
gradient's size, so parameters agree at rtol 2e-4 / atol 5e-6.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_update_kernel import _setup, _setup_categorical

import gym_fishing_tpu as gft
import gym_fishing_tpu_torch as gtt
from gym_fishing_tpu.agents import ppo as jppo
from gym_fishing_tpu.agents import ppo_fused as jfused
from gym_fishing_tpu.batch import batched_reset as j_batched_reset
from gym_fishing_tpu.envs.wrappers import stack_observations as j_stack_observations
from gym_fishing_tpu_torch.agents import ppo
from gym_fishing_tpu_torch.batch import batched_reset
from gym_fishing_tpu_torch.bench import measure_ppo_train
from gym_fishing_tpu_torch.convert import (
    actor_critic_from_numpy,
    actor_critic_to_numpy,
    adam_state_from_numpy,
)
from gym_fishing_tpu_torch.envs.wrappers import stack_observations

# the port's entry points default to the card; these tests run on the CPU
make = functools.partial(gtt.make, device="cpu")
make_train_state = functools.partial(ppo.make_train_state, device="cpu")
train = functools.partial(ppo.train, device="cpu")
actor_critic_from_numpy = functools.partial(actor_critic_from_numpy, device="cpu")

torch.set_num_threads(1)

ENV_IDS = {"gaussian": "fishing-v1", "categorical": "fishing-v0"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_close(got, want, rtol, atol):
    want = _np(want)
    got_leaves = {jax.tree_util.keystr(k): v for k, v in jax.tree.leaves_with_path(got)}
    paths = jax.tree.leaves_with_path(want)
    assert len(got_leaves) == len(paths)
    for k, ref in paths:
        np.testing.assert_allclose(got_leaves[jax.tree_util.keystr(k)], ref, rtol=rtol,
                                   atol=atol, err_msg=jax.tree_util.keystr(k))


def _port_state(ts) -> ppo.TrainState:
    adam = jfused._find_adam_state(ts.opt_state)
    m, v, count = adam_state_from_numpy(_np(adam.mu), _np(adam.nu), adam.count)
    return ppo.TrainState(model=actor_critic_from_numpy(_np(ts.params)), m=m, v=v,
                          count=count, step=int(ts.step))


def _jax_draws(key, cfg, head, n_actions):
    """JAX train_step(key)'s rollout draws, and its permutation key."""
    k_roll, k_perm = jax.random.split(key)
    b = cfg.num_envs
    act, env = [], []
    for step_key in jax.random.split(k_roll, cfg.num_steps):
        k_act, k_env = jax.random.split(step_key)
        if head == "gaussian":
            act.append(jax.random.normal(k_act, (b, 1), jnp.float32))
        else:
            act.append(jax.random.gumbel(k_act, (b, n_actions), jnp.float32))
        env.append(jax.random.normal(k_env, (2, b), jnp.float32))
    to_t = lambda xs: torch.from_numpy(np.stack([np.asarray(x) for x in xs]))  # noqa: E731
    return to_t(act), to_t(env), k_perm


# ------------------------------------------------------------------ network

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head", ["gaussian", "categorical"])
def test_actor_critic_matches_flax(head, dtype):
    env, _ = gft.make(ENV_IDS[head])
    cfg = jppo.PPOConfig(compute_dtype=dtype)
    ts = jppo.make_train_state(env, cfg, jax.random.key(3))
    obs = np.random.default_rng(0).uniform(-1, 1, (64, 1)).astype(np.float32)
    jdist, jvalue = ts.apply_fn(ts.params, jnp.asarray(obs))
    model = actor_critic_from_numpy(_np(ts.params), compute_dtype=getattr(torch, dtype))
    with torch.no_grad():
        dist, value = model(torch.from_numpy(obs))
    # bf16: both round the same values (inputs, weights, product, bias add,
    # tanh) to bf16, so only the f32 heads' summation order differs
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), **tol)
    for got, want in zip(dist, jdist):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    assert value.dtype == dist[0].dtype == torch.float32


def test_converters_round_trip_the_flax_tree():
    env, _ = gft.make("fishing-v1")
    ts = jppo.make_train_state(env, jppo.PPOConfig(hidden=32), jax.random.key(0))
    tree = _np(ts.params)
    back = actor_critic_to_numpy(actor_critic_from_numpy(tree))
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    m, v, count = adam_state_from_numpy(tree, tree, np.int32(7))
    assert count == 7 and set(m) == set(v) == set(dict(
        actor_critic_from_numpy(tree).named_parameters()))


# --------------------------------------------------------------------- loss

@pytest.mark.parametrize("ent_coef", [0.0, 0.01])
@pytest.mark.parametrize("head", ["gaussian", "categorical"])
def test_ppo_loss_and_grads_match_jax(head, ent_coef):
    if head == "gaussian":
        cfg, ts, params, batch, _ = _setup(ent_coef=ent_coef)
    else:
        cfg, ts, params, batch, _, _ = _setup_categorical(ent_coef=ent_coef)
    continuous = head == "gaussian"
    (_, j_met), j_grads = jax.value_and_grad(
        lambda p: jppo.ppo_loss(ts.apply_fn, p, cfg, batch, continuous), has_aux=True)(params)
    model = actor_critic_from_numpy(_np(params))
    tbatch = tuple(torch.from_numpy(np.array(x)) for x in batch)
    loss, met = ppo.ppo_loss(model, ppo.PPOConfig(**dataclasses.asdict(cfg)), tbatch,
                             continuous)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    _assert_trees_close(actor_critic_to_numpy(dict(zip(names, grads))), j_grads, rtol=2e-4,
                        atol=2e-6)
    for name, want in j_met.items():
        np.testing.assert_allclose(float(met[name].detach()), float(want), rtol=2e-5,
                                   atol=1e-7, err_msg=name)


def test_ppo_loss_uses_the_population_std():
    """At 4 samples the unbiased std is 15% larger than jnp.std's population
    std, which moves pg_loss by as much: the port matches JAX, and the
    unbiased normalisation would not."""
    cfg, ts, params, batch, _ = _setup(n=256)
    batch = tuple(x[:4] for x in batch)
    (_, j_met), _ = jax.value_and_grad(
        lambda p: jppo.ppo_loss(ts.apply_fn, p, cfg, batch, True), has_aux=True)(params)
    model = actor_critic_from_numpy(_np(params))
    obs, action, old_logp, _, adv, _ = (torch.from_numpy(np.array(x)) for x in batch)
    _, met = ppo.ppo_loss(model, ppo.PPOConfig(**dataclasses.asdict(cfg)),
                          (obs, action, old_logp, *(torch.from_numpy(np.array(x))
                                                    for x in batch[3:])), True)
    np.testing.assert_allclose(float(met["pg_loss"].detach()), float(j_met["pg_loss"]),
                               rtol=1e-5)
    with torch.no_grad():
        dist, _ = model(obs)
        ratio = torch.exp(ppo.action_logp_entropy(dist, action, True)[0] - old_logp)
        adv_n = (adv - adv.mean()) / (adv.std() + 1e-8)   # unbiased
        pg_unbiased = -torch.minimum(ratio * adv_n,
                                     torch.clamp(ratio, 0.8, 1.2) * adv_n).mean()
    want = float(j_met["pg_loss"])
    assert abs(float(pg_unbiased) - want) > 0.05 * abs(want)


def test_apply_gradients_matches_optax():
    """Hand-written clip-by-global-norm + Adam (+ the linear schedule) ≡
    the optax chain, below and above the clip threshold."""
    cfg = ppo.PPOConfig(max_grad_norm=0.5, anneal_lr=True, total_iterations=1, epochs=2,
                        num_minibatches=2)
    env, _ = gft.make("fishing-v1")
    jts = jppo.make_train_state(env, jppo.PPOConfig(**dataclasses.asdict(cfg)),
                                jax.random.key(1))
    ts = _port_state(jts)
    rng = np.random.default_rng(0)
    for scale in (1e-3, 0.3, 2.0, 1e-2):   # norms below and above 0.5
        g_tree = jax.tree.map(
            lambda x: jnp.asarray(scale * rng.standard_normal(x.shape).astype(np.float32)),
            jts.params)
        jts = jts.apply_gradients(grads=g_tree)
        named = {k: torch.from_numpy(np.array(v)) for k, v in _named(g_tree).items()}
        ppo.apply_gradients(ts, named, cfg)
    _assert_trees_close(actor_critic_to_numpy(ts.model), jts.params, rtol=1e-6, atol=1e-7)
    adam = jfused._find_adam_state(jts.opt_state)
    _assert_trees_close(actor_critic_to_numpy(ts.m), adam.mu, rtol=1e-6, atol=1e-9)
    _assert_trees_close(actor_critic_to_numpy(ts.v), adam.nu, rtol=1e-6, atol=1e-12)
    assert ts.count == int(adam.count) == 4


def _named(tree):
    tree = _np(tree)["params"]
    out = {}
    for layer, val in tree.items():
        if isinstance(val, dict):
            out[f"{layer}.weight"] = val["kernel"].T
            out[f"{layer}.bias"] = val["bias"]
        else:
            out[layer] = val
    return out


# ------------------------------------------------------------------ rollout

@pytest.mark.parametrize("head", ["gaussian", "categorical"])
def test_collect_rollout_and_gae_match_jax(head):
    env_id = ENV_IDS[head]
    jenv, jparams = gft.make(env_id, sigma=0.1, Tmax=10)   # episodes end inside the window
    cfg = jppo.PPOConfig(num_envs=32, num_steps=16, hidden=32)
    ts = jppo.make_train_state(jenv, cfg, jax.random.key(2))
    key = jax.random.key(9)
    _, _, j_traj, j_last = jppo.collect_rollout(jenv, jparams, cfg, ts,
                                                j_batched_reset(jenv, jparams, cfg.num_envs),
                                                jax.random.split(key)[0])
    j_adv, j_ret = jppo.compute_gae(cfg, j_traj, j_last)
    act_noise, env_noise, _ = _jax_draws(key, cfg, head, jenv.config.n_actions)
    if head == "categorical":   # Gumbel-max is what jax.random.categorical draws
        logits = jax.random.normal(jax.random.key(0), (8, 3))
        k = jax.random.key(5)
        assert bool((jax.random.categorical(k, logits)
                     == jnp.argmax(logits + jax.random.gumbel(k, logits.shape), -1)).all())

    env, params = make(env_id, sigma=0.1, Tmax=10)
    pcfg = ppo.PPOConfig(**dataclasses.asdict(cfg))
    model = actor_critic_from_numpy(_np(ts.params))
    _, _, traj, last = ppo.collect_rollout(env, params, pcfg, model,
                                           batched_reset(env, params, cfg.num_envs),
                                           act_noise=act_noise, env_noise=env_noise)
    adv, ret = ppo.compute_gae(pcfg, traj, last)
    for name in ("obs", "action", "logp", "value", "reward", "episode_return"):
        np.testing.assert_allclose(getattr(traj, name).numpy(),
                                   np.asarray(getattr(j_traj, name)), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    for name in ("done", "episode_length"):
        np.testing.assert_array_equal(getattr(traj, name).numpy(),
                                      np.asarray(getattr(j_traj, name)), err_msg=name)
    assert bool(traj.done.any())   # auto-reset happened inside the window
    np.testing.assert_allclose(last.numpy(), np.asarray(j_last), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(adv.numpy(), np.asarray(j_adv), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ret.numpy(), np.asarray(j_ret), rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------- train step

def _step_pair(head, form, env_id=None, stack=0, **overrides):
    """One JAX train_step and the port's, from the same weights and draws:
    ((jax ts, metrics), (port ts, metrics)). With `stack` both envs are
    wrapped in a window of that many observations."""
    env_id = env_id or ENV_IDS[head]
    jenv, jparams = gft.make(env_id, sigma=0.1)
    if stack:
        jenv = j_stack_observations(jenv, stack)
    base = dict(num_envs=32, num_steps=16, epochs=2, num_minibatches=2, hidden=32,
                ent_coef=0.01, fused_update=form != "off", fused_adam=form == "adam")
    cfg = jppo.PPOConfig(**{**base, **overrides})
    key = jax.random.key(17)
    ts0 = jppo.make_train_state(jenv, cfg, jax.random.key(4))
    j_ts, _, j_met = jax.jit(
        lambda ts, bs, k: jppo.train_step(jenv, jparams, cfg, ts, bs, k)
    )(ts0, j_batched_reset(jenv, jparams, cfg.num_envs), key)

    act_noise, env_noise, k_perm = _jax_draws(key, cfg, head, jenv.config.n_actions)
    n = cfg.num_envs * cfg.num_steps
    if form == "off":
        size = n
    else:
        mb = n // cfg.num_minibatches
        size = n // next(t for t in (2048, 1024, 512, 256, 128) if mb % t == 0)
    perms = [torch.from_numpy(np.array(jax.random.permutation(k, size)))
             for k in jax.random.split(k_perm, cfg.epochs)]
    env, params = make(env_id, sigma=0.1)
    if stack:
        env = stack_observations(env, stack)
    ts = _port_state(ts0)
    ts, _, met = ppo.train_step(env, params, ppo.PPOConfig(**dataclasses.asdict(cfg)), ts,
                                batched_reset(env, params, cfg.num_envs), perms=perms,
                                act_noise=act_noise, env_noise=env_noise)
    return (j_ts, j_met), (ts, met)


def _assert_steps_agree(pair, metric_rtol=2e-4):
    (j_ts, j_met), (ts, met) = pair
    _assert_trees_close(actor_critic_to_numpy(ts.model), j_ts.params, rtol=2e-4, atol=5e-6)
    adam = jfused._find_adam_state(j_ts.opt_state)
    _assert_trees_close(actor_critic_to_numpy(ts.m), adam.mu, rtol=2e-4, atol=5e-7)
    _assert_trees_close(actor_critic_to_numpy(ts.v), adam.nu, rtol=5e-4, atol=1e-9)
    assert ts.count == int(adam.count) and ts.step == int(j_ts.step)
    assert set(met) == set(j_met)
    for name, want in j_met.items():
        np.testing.assert_allclose(float(met[name]), float(want), rtol=metric_rtol, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("head,anneal", [("gaussian", False), ("categorical", False),
                                         ("gaussian", True)])
def test_plain_train_step_matches_jax(head, anneal):
    _assert_steps_agree(_step_pair(head, "off", anneal_lr=anneal, total_iterations=2))


def test_unported_options_raise():
    env, params = make("fishing-v1")
    ts = make_train_state(env, ppo.PPOConfig(hidden=32), torch.Generator().manual_seed(0))
    bstate = batched_reset(env, params, 16)
    for cfg, match in ((ppo.PPOConfig(num_envs=16, fused_update=True, fused_rollout=True,
                                      rollout_vector_gae=True), "vector_gae"),
                       (ppo.PPOConfig(num_envs=16, shuffle="affine"), "affine")):
        with pytest.raises(NotImplementedError, match=match):
            ppo.train_step(env, params, cfg, ts, bstate, torch.Generator())
    with pytest.raises(ValueError, match="unknown fused form"):
        measure_ppo_train(num_envs=16, num_steps=8, fused="xla", device="cpu")


@pytest.mark.parametrize("form", ["off", "update", "adam"])
def test_train_step_is_deterministic(form):
    """Two identical train steps give identical bits (the CUDA kernels sum
    in a fixed order too: no float atomics)."""
    env, params = make("fishing-v1", sigma=0.1)
    cfg = ppo.PPOConfig(num_envs=32, num_steps=16, epochs=2, num_minibatches=2, hidden=32,
                        fused_update=form != "off", fused_adam=form == "adam")
    ts0 = make_train_state(env, cfg, torch.Generator().manual_seed(0))
    outs = []
    for _ in range(2):
        ts, _, met = ppo.train_step(env, params, cfg, ts0.clone(),
                                    batched_reset(env, params, cfg.num_envs),
                                    torch.Generator().manual_seed(3))
        outs.append((ts, met))
    for p, q in zip(outs[0][0].model.parameters(), outs[1][0].model.parameters()):
        assert torch.equal(p, q)
    assert float(outs[0][1]["loss"]) == float(outs[1][1]["loss"])
    assert any(not torch.equal(p, q) for p, q in
               zip(outs[0][0].model.parameters(), ts0.model.parameters()))


@pytest.mark.parametrize("env_id", ["fishing-v1", "fishing-v0"])
def test_train_and_policy(env_id):
    env, params = make(env_id, sigma=0.05)
    cfg = ppo.PPOConfig(num_envs=64, num_steps=32, epochs=2, num_minibatches=4, hidden=32,
                        fused_update=True, fused_adam=env_id == "fishing-v1")
    ts, hist = train(env, cfg, seed=1, iterations=2, env_params=params)
    assert len(hist) == 2 and np.isfinite(hist[-1]["loss"])
    assert ts.count == ts.step == 2 * cfg.epochs * cfg.num_minibatches
    act, state = ppo.PPOPolicy(env, ts).predict(np.zeros((5, 1), np.float32))
    assert act.shape == ((5, 1) if env_id == "fishing-v1" else (5,)) and state is None


@pytest.mark.parametrize("fused,fused_adam", [("off", False), ("update", False),
                                              ("update", True), ("full", False),
                                              ("full", True)])
def test_measure_ppo_train_on_cpu_when_asked(fused, fused_adam):
    res = measure_ppo_train(num_envs=64, num_steps=32, iters=1, warmup=1, fused=fused,
                            fused_adam=fused_adam, device="cpu")
    assert res["device"] == "cpu" and res["mode"] == f"ppo-{fused}" + (
        "+adam" if fused_adam else "")
    assert res["steps_per_s"] > 0 and res["epochs"] == 4 and res["num_minibatches"] == 8
    assert res["rollout_flags"] == {"pregen_noise": False, "fold_obs": fused == "full",
                                    "vector_gae": False}


def test_measure_ppo_train_takes_the_width_and_env_on_cpu():
    """The PPO iteration timer at another width and env (a categorical head
    of 5 classes, K4 + K3), reading every metric after each iteration."""
    res = measure_ppo_train(num_envs=64, num_steps=32, iters=1, warmup=1, fused="full",
                            fused_adam=True, device="cpu", hidden=32, env_id="fishing-v0",
                            env_kwargs={"n_actions": 5}, read_metrics=True)
    assert res["hidden"] == 32 and res["env"] == "fishing-v0" and res["mode"] == "ppo-full+adam"
    assert res["ms_per_iter"] > 0 and np.isfinite(res["loss"])


