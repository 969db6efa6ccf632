"""The port's fused policy rollout (K4) on the CPU, where its wrapper runs the
plain twin `policy_rollout_reference`, and the fused-full train step.

- Twin vs JAX `ppo_fused.fused_rollout_collect(..., interpret=True)` at the
  JAX test's sizes (B=256, T=8, hidden 32) over the 7 cases of
  tests/test_policy_rollout_kernel.py, fold on and off, from the same
  jittered weights (converted from the flax tree, never re-seeded). The
  Mosaic interpreter's PRNG yields zero bits on the CPU, so the JAX kernel
  draws z = 0, u = 1 and nf = 1: the twin is fed those planes. Tolerances
  are the JAX test's: packed rows rtol 2e-5 / atol 1e-5, stock rtol 1e-6,
  t and ep_len exact, stats rtol 1e-5 / atol 1e-4.
- Twin vs the port's plain collect_rollout + compute_gae + _pack on the same
  non-zero numpy-made planes (Gaussian head), in float32: the two run the
  same arithmetic in another order (merged vs split towers), so values
  agree to 1e-5.
- The twin from a seed: deterministic, `next_offset` chaining draws fresh
  numbers, Gaussian z-scores are N(0, 1) and categorical classes follow the
  softmax.
- The fused-full train step against JAX's (interpret mode) from the same
  weights, draws and tile permutations; its refusals; a finite step per
  head; and the build hash over the shared headers.
- What the wrapper refuses before a launch: sizes the CUDA kernel does not
  take, and anything but the 13 split-tower arrays at their shapes. The
  kernel multiplies per tower and relies on zero cross-tower blocks; the
  wrapper merges the towers itself, so no call can hand it another.

The CUDA kernel itself is held against the twin on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses
import functools
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ppo import _assert_steps_agree, _port_state

from gym_fishing_tpu import registry
from gym_fishing_tpu.agents import ppo as jppo
from gym_fishing_tpu.agents import ppo_fused as jfused
from gym_fishing_tpu.batch import batched_reset as j_batched_reset
from gym_fishing_tpu.core.types import EnvState as JEnvState
import gym_fishing_tpu_torch as gtt
from gym_fishing_tpu_torch.agents import ppo, ppo_fused
from gym_fishing_tpu_torch.batch import batched_reset
from gym_fishing_tpu_torch.convert import (
    actor_critic_from_numpy,
    batch_state_from_numpy,
    params_from_numpy,
)
from gym_fishing_tpu_torch.kernels import _build
from gym_fishing_tpu_torch.kernels import policy_rollout_kernel as pk
from gym_fishing_tpu_torch.kernels import ppo_update_kernel as uk

# the port's entry points default to the card; these tests run on the CPU
make = functools.partial(gtt.make, device="cpu")
make_train_state = functools.partial(ppo.make_train_state, device="cpu")
train = functools.partial(ppo.train, device="cpu")
actor_critic_from_numpy = functools.partial(actor_critic_from_numpy, device="cpu")
batch_state_from_numpy = functools.partial(batch_state_from_numpy, device="cpu")

torch.set_num_threads(1)

JAX_CASES = [   # tests/test_policy_rollout_kernel.py:115-132
    ("fishing-v1", dict(sigma=0.05, Tmax=5)),
    ("fishing-ricker-v1", dict(sigma=0.1, Tmax=6, cost=0.1, r_drift=0.01)),
    ("fishing-may-v1", dict(sigma=0.0, Tmax=7, collapse_penalty=1.0)),
    ("fishing-v0", dict(sigma=0.05, Tmax=5)),
    ("fishing-v0", dict(n_actions=8, sigma=0.1, Tmax=6, cost=0.05)),
    ("fishing-may-obs-v1", dict(Tmax=6)),
    ("fishing-mixture-v1", dict(model_idx=3, sigma=0.05, Tmax=5)),
]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_params(jparams):
    return params_from_numpy(
        {f.name: np.asarray(getattr(jparams, f.name)) for f in dataclasses.fields(jparams)},
        torch.float32, "cpu")


def _port_bstate(jb):
    return batch_state_from_numpy(dict(
        stock=np.asarray(jb.env.stock), harvest=np.asarray(jb.env.harvest),
        t=np.asarray(jb.env.t), episode_return=np.asarray(jb.episode_return),
        episode_length=np.asarray(jb.episode_length)))


def _jax_case(env_id, overrides, fold, num_envs=256, num_steps=8, hidden=32, **cfg_extra):
    """The JAX test's setup (tests/test_policy_rollout_kernel.py:138-168):
    jittered weights and desynchronised instances."""
    env, params = registry.make(env_id, dtype=jnp.float32, **overrides)
    cfg = jppo.PPOConfig(num_envs=num_envs, num_steps=num_steps, hidden=hidden,
                         rollout_fold_obs=fold, **cfg_extra)
    ts = jppo.make_train_state(env, cfg, jax.random.key(0))
    ts = ts.replace(params=jax.tree.map(
        lambda x: x + 0.03 * jnp.cos(jnp.arange(x.size, dtype=jnp.float32)).reshape(x.shape),
        ts.params))
    bstate = j_batched_reset(env, params, num_envs)
    bstate = bstate.replace(
        env=JEnvState(
            stock=bstate.env.stock * (0.5 + jnp.linspace(0, 1, num_envs, dtype=jnp.float32)),
            harvest=bstate.env.harvest
            * (0.5 + jnp.linspace(0, 1.5, num_envs, dtype=jnp.float32)),
            t=(jnp.arange(num_envs) % int(params.Tmax)).astype(jnp.int32),
        ),
        episode_length=(jnp.arange(num_envs) % int(params.Tmax)).astype(jnp.int32),
    )
    return env, params, cfg, ts, bstate


def _z0_planes(scheme, obs_noise, T, B):
    """The Mosaic interpreter's draws: z = 0, u = 1, nf = 1."""
    first = torch.zeros if scheme == "continuous" else torch.ones
    planes = [first((T, B)), torch.zeros((T, B))]
    if obs_noise:
        planes.append(torch.ones((T, B)))
    return torch.stack(planes)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("env_id,overrides", JAX_CASES)
def test_twin_matches_jax_kernel_z0(env_id, overrides, fold):
    _assert_twin_matches_jax_z0(env_id, overrides, fold)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("env_id,overrides,hidden", [
    ("fishing-v1", dict(sigma=0.05, Tmax=5), 256),
    ("fishing-v0", dict(n_actions=100, sigma=0.05, Tmax=5), 32),    # the proportional grid
    ("fishing-v0", dict(n_actions=100, sigma=0.05, Tmax=5), 256),
])
def test_twin_matches_jax_kernel_z0_at_the_wide_widths(env_id, overrides, hidden, fold):
    """Hidden 256 and the categorical head of 100 classes, under the same
    bars; the interpreter's u = 1 takes the last class of the 100."""
    _assert_twin_matches_jax_z0(env_id, overrides, fold, hidden=hidden)


def _assert_twin_matches_jax_z0(env_id, overrides, fold, hidden=32):
    jenv, jparams, jcfg, jts, jb = _jax_case(env_id, overrides, fold, hidden=hidden)
    jroll, jnext = jfused.fused_rollout_collect(jenv, jparams, jcfg, jts, jb,
                                                jax.random.key(0), interpret=True)

    env, _ = make(env_id, **overrides)
    params = _port_params(jparams)
    cfg = ppo.PPOConfig(**dataclasses.asdict(jcfg))
    ts = ppo.TrainState(model=actor_critic_from_numpy(_np(jts.params)), m={}, v={})
    obs_noise = float(params.sigma_m) > 0
    before = pk.launches
    roll, nxt = ppo_fused.fused_rollout_collect(
        env, params, cfg, ts, _port_bstate(jb),
        noise=_z0_planes(env.config.scheme, obs_noise, cfg.num_steps, cfg.num_envs))
    assert pk.launches == before   # the twin ran, not the kernel
    names = ("obs", "action", "logp", "value", "advantage", "return", "pad", "pad")
    for r, name in enumerate(names):
        np.testing.assert_allclose(roll.packed_t[r].numpy(), np.asarray(jroll.packed_t[r]),
                                   rtol=2e-5, atol=1e-5, err_msg=f"packed row {name}")
    np.testing.assert_allclose(nxt.env.stock.numpy(), np.asarray(jnext.env.stock),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(nxt.env.harvest.numpy(), np.asarray(jnext.env.harvest),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(nxt.env.t.numpy(), np.asarray(jnext.env.t))
    np.testing.assert_allclose(nxt.episode_return.numpy(), np.asarray(jnext.episode_return),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(nxt.episode_length.numpy(),
                                  np.asarray(jnext.episode_length))
    np.testing.assert_allclose(roll.stats.numpy(), np.asarray(jroll.stats), rtol=1e-5,
                               atol=1e-4)
    assert float(roll.stats[0]) > 0   # episodes ended inside the window


def _plain_case(env_id, fold, B=96, T=24):
    env, params = make(env_id, sigma=0.1, Tmax=10)
    cfg = ppo.PPOConfig(num_envs=B, num_steps=T, hidden=32, rollout_fold_obs=fold)
    ts = make_train_state(env, cfg, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for p in ts.model.parameters():
            p.add_(torch.from_numpy(0.1 * rng.standard_normal(p.shape).astype(np.float32)))
    bstate = batched_reset(env, params, B)
    bstate = bstate.replace(
        env=bstate.env.replace(
            stock=torch.from_numpy(rng.uniform(0.2, 1.4, B).astype(np.float32)),
            t=torch.from_numpy(rng.integers(0, 10, B).astype(np.int32))),
        episode_return=torch.from_numpy(rng.uniform(0, 2, B).astype(np.float32)))
    act_noise = torch.from_numpy(rng.standard_normal((T, B, 1)).astype(np.float32))
    env_noise = torch.from_numpy(rng.standard_normal((T, 2, B)).astype(np.float32))
    return env, params, cfg, ts, bstate, act_noise, env_noise


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("env_id", ["fishing-v1", "fishing-may-obs-v1"])
def test_twin_matches_plain_rollout_path(env_id, fold):
    env, params, cfg, ts, bstate, act_noise, env_noise = _plain_case(env_id, fold)
    obs_noise = float(params.sigma_m) > 0
    roll, nxt = ppo_fused.fused_rollout_collect(
        env, params, cfg, ts, bstate,
        noise=ppo_fused.rollout_noise_from_draws(act_noise, env_noise, float(params.sigma_m),
                                                 obs_noise))
    b2, _, traj, last = ppo.collect_rollout(env, params, cfg, ts.model, bstate,
                                            act_noise=act_noise, env_noise=env_noise)
    adv, ret = ppo.compute_gae(cfg, traj, last)
    packed = ppo._pack(traj, adv, ret).T
    np.testing.assert_allclose(roll.packed_t[:6].numpy(), packed.numpy(), rtol=1e-5, atol=1e-5)
    assert not roll.packed_t[6:].any()
    for got, want in ((nxt.env.stock, b2.env.stock), (nxt.env.harvest, b2.env.harvest),
                      (nxt.episode_return, b2.episode_return)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(nxt.env.t.numpy(), b2.env.t.numpy())
    np.testing.assert_array_equal(nxt.episode_length.numpy(), b2.episode_length.numpy())
    done = traj.done.float()
    want = torch.stack([done.sum(), (traj.episode_return * done).sum(),
                        (traj.episode_length.float() * done).sum(), traj.reward.sum()])
    np.testing.assert_allclose(roll.stats.numpy(), want.numpy(), rtol=1e-5, atol=1e-4)
    assert float(roll.stats[0]) > 0


def _seeded(env_id, B=4096, T=8, seed=11, offset=0, fold=False):
    env, params = make(env_id, sigma=0.1)
    cfg = ppo.PPOConfig(num_envs=B, num_steps=T, hidden=32)
    ts = make_train_state(env, cfg, torch.Generator().manual_seed(4))
    head = "gaussian" if env.config.scheme == "continuous" else "categorical"
    weights = ppo_fused.merged_weights(ts.params(), head)
    bstate = batched_reset(env, params, B)
    bstate = bstate.replace(env=bstate.env.replace(stock=torch.linspace(0.2, 1.8, B)))
    roll = pk.policy_rollout(
        bstate.env.stock, bstate.env.t, bstate.env.harvest, bstate.episode_return,
        bstate.episode_length, weights, ppo_fused.rollout_scalars(params, seed, offset), T,
        scheme=env.config.scheme, n_actions=env.config.n_actions, fold_obs=fold)
    return roll, ts.model


@pytest.mark.parametrize("env_id", ["fishing-v1", "fishing-v0"])
def test_seeded_twin_is_deterministic_and_chains(env_id):
    a, _ = _seeded(env_id)
    b, _ = _seeded(env_id)
    assert torch.equal(a.packed_t, b.packed_t) and torch.equal(a.stats, b.stats)
    assert a.next_offset == pk.draws_per_call(8) == 8
    c, _ = _seeded(env_id, offset=a.next_offset)
    assert c.next_offset == 16
    # same start state, fresh draws: the actions (row 1) differ
    assert float((c.packed_t[1] == a.packed_t[1]).float().mean()) < (
        0.001 if env_id == "fishing-v1" else 0.7)


def test_seeded_gaussian_draws_are_standard_normal():
    roll, model = _seeded("fishing-v1", fold=False)
    obs, act = roll.packed_t[0], roll.packed_t[1]
    with torch.no_grad():
        (mean, log_std), _ = model(obs[:, None])
    log_std = log_std.detach()
    z = ((act - mean[:, 0]) / torch.exp(log_std)).double()
    n = z.numel()
    assert abs(float(z.mean())) < 5 / math.sqrt(n)
    assert abs(float(z.std()) - 1) < 5 * math.sqrt(0.5 / n)
    # logp is the Gaussian density at z
    want = -0.5 * z * z - float(log_std) - 0.5 * pk.LOG_2PI
    np.testing.assert_allclose(roll.packed_t[2].double().numpy(), want.numpy(), atol=1e-5)


def test_seeded_categorical_classes_follow_the_softmax():
    roll, model = _seeded("fishing-v0", fold=False)
    obs, act = roll.packed_t[0], roll.packed_t[1].long()
    with torch.no_grad():
        (logits,), _ = model(obs[:, None])
    probs = torch.softmax(logits.double(), -1)
    counts = torch.bincount(act, minlength=3).double()
    expect = probs.sum(0)
    sd = torch.sqrt((probs * (1 - probs)).sum(0))
    assert bool(((counts - expect).abs() < 5 * sd + 1).all()), (counts, expect)
    logp = torch.log(probs).gather(1, act[:, None])[:, 0]
    np.testing.assert_allclose(roll.packed_t[2].double().numpy(), logp.numpy(), atol=1e-5)


# --------------------------------------------------------------- train step

def _full_step_pair(head, form, hidden=32, **env_extra):
    """One JAX fused-full train_step (kernels in interpret mode: the rollout
    draws z = 0, u = 1) and the port's from the same weights and start
    state, the z = 0 planes and JAX's tile permutations. The Gaussian mean
    starts near -0.5 so that envs outlive a step and the advantages spread
    (identical samples would make the advantage std 0)."""
    env_id = {"gaussian": "fishing-v1", "categorical": "fishing-v0"}[head]
    overrides = dict(sigma=0.1, Tmax=10, **env_extra)
    jenv, jparams, cfg, ts0, jb = _jax_case(
        env_id, overrides, True, num_envs=128, num_steps=16, hidden=hidden, epochs=2,
        num_minibatches=2, ent_coef=0.01, fused_update=True, fused_rollout=True,
        fused_adam=form == "adam")
    if head == "gaussian":
        tree = _np(ts0.params)
        tree["params"]["pi_mean"]["bias"] = tree["params"]["pi_mean"]["bias"] - 0.5
        ts0 = ts0.replace(params=jax.tree.map(jnp.asarray, tree))
    key = jax.random.key(17)
    j_ts, _, j_met = jax.jit(
        lambda ts, bs, k: jppo.train_step(jenv, jparams, cfg, ts, bs, k)
    )(ts0, jb, key)

    _, k_perm = jax.random.split(key)
    n = cfg.num_envs * cfg.num_steps
    tile = next(t for t in (2048, 1024, 512, 256, 128) if (n // cfg.num_minibatches) % t == 0)
    perms = [torch.from_numpy(np.array(jax.random.permutation(k, n // tile)))
             for k in jax.random.split(k_perm, cfg.epochs)]
    env, _ = make(env_id, **overrides)
    ts, _, met = ppo.train_step(
        env, _port_params(jparams), ppo.PPOConfig(**dataclasses.asdict(cfg)), _port_state(ts0),
        _port_bstate(jb), perms=perms,
        rollout_noise=_z0_planes(env.config.scheme, False, cfg.num_steps, cfg.num_envs))
    assert 1 < float(met["episode_length"]) <= 10 and float(met["v_loss"]) > 0
    return (j_ts, j_met), (ts, met)


@pytest.mark.parametrize("head,form", [("gaussian", "adam"), ("categorical", "update")])
def test_full_train_step_matches_jax(head, form):
    _assert_steps_agree(_full_step_pair(head, form))


def test_full_adam_train_step_matches_jax_at_hidden_128_and_100_actions():
    """full + fused_adam on fishing-v0's proportional grid of 100 quotas at
    hidden 128, the widths of the kernels' wide path. The interpreter's u = 1
    takes the last class, a quota of 99 % of K, for every env: the envs start
    at 1 to 3 K (init_state 2) so that they outlive their first harvest and
    the advantages spread, and the update runs the softmax and its gradient
    over the 100 classes."""
    _assert_steps_agree(_full_step_pair("categorical", "adam", hidden=128, n_actions=100,
                                        init_state=2.0))


def test_full_matches_update_form_from_the_same_draws():
    """full + fused_adam ≡ update + fused_adam after one step at 1 epoch x 1
    minibatch, the rollout fed the same planes."""
    env, params = make("fishing-v1", sigma=0.1, Tmax=10)
    B, T = 128, 16
    base = ppo.PPOConfig(num_envs=B, num_steps=T, epochs=1, num_minibatches=1, hidden=32,
                         fused_update=True, fused_adam=True, rollout_fold_obs=False)
    ts0 = make_train_state(env, base, torch.Generator().manual_seed(2))
    rng = np.random.default_rng(8)
    act = torch.from_numpy(rng.standard_normal((T, B, 1)).astype(np.float32))
    env_n = torch.from_numpy(rng.standard_normal((T, 2, B)).astype(np.float32))
    perms = [torch.zeros(1, dtype=torch.int32)]
    upd, _, m_upd = ppo.train_step(env, params, base, ts0.clone(), batched_reset(env, params, B),
                                   perms=perms, act_noise=act, env_noise=env_n)
    full, _, m_full = ppo.train_step(
        env, params, dataclasses.replace(base, fused_rollout=True), ts0.clone(),
        batched_reset(env, params, B), perms=perms,
        rollout_noise=ppo_fused.rollout_noise_from_draws(act, env_n, 0.0, False))
    for p, q in zip(full.model.parameters(), upd.model.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=5e-4, atol=1e-6)
    for name, want in m_upd.items():
        np.testing.assert_allclose(float(m_full[name]), float(want), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("adam", [False, True])
@pytest.mark.parametrize("env_id,overrides", [
    ("fishing-v1", {}), ("fishing-v0", dict(ent_coef=0.01)), ("fishing-mixture-v1", {}),
])
def test_full_train_step_is_finite(env_id, overrides, adam):
    env, params = make(env_id, sigma=0.05, model_idx=1) if "mixture" in env_id else (
        make(env_id, sigma=0.05))
    cfg = ppo.PPOConfig(num_envs=128, num_steps=16, epochs=2, num_minibatches=2, hidden=32,
                        fused_update=True, fused_rollout=True, fused_adam=adam, **overrides)
    ts = make_train_state(env, cfg, torch.Generator().manual_seed(0))
    bstate = batched_reset(env, params, cfg.num_envs)
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        ts, bstate, met = ppo.train_step(env, params, cfg, ts, bstate, gen)
    assert math.isfinite(float(met["loss"])) and math.isfinite(float(met["mean_reward"]))
    assert all(bool(torch.isfinite(p).all()) for p in ts.model.parameters())
    assert ts.step == 2 * cfg.epochs * cfg.num_minibatches


def test_train_runs_the_full_form():
    env, _ = make("fishing-v1", sigma=0.05)
    cfg = ppo.PPOConfig(num_envs=128, num_steps=16, epochs=2, num_minibatches=2, hidden=32,
                        fused_update=True, fused_rollout=True, fused_adam=True)
    ts, hist = train(env, cfg, seed=2, iterations=2)
    assert len(hist) == 2 and all(math.isfinite(h["loss"]) for h in hist)
    assert ts.count == 2 * cfg.epochs * cfg.num_minibatches


def test_fused_rollout_refusals():
    env, params = make("fishing-v1")
    ts = make_train_state(env, ppo.PPOConfig(hidden=32), torch.Generator().manual_seed(0))
    bstate = batched_reset(env, params, 16)
    cases = [
        (ppo.PPOConfig(num_envs=16, num_steps=4, fused_rollout=True), NotImplementedError,
         "requires fused_update"),
        (ppo.PPOConfig(num_envs=16, num_steps=4, fused_update=True, fused_rollout=True,
                       rollout_vector_gae=True), NotImplementedError, "vector_gae"),
    ]
    for cfg, exc, match in cases:
        with pytest.raises(exc, match=match):
            ppo.train_step(env, params, cfg, ts, bstate, torch.Generator())
    cfg = ppo.PPOConfig(num_envs=16, num_steps=4, fused_update=True, fused_rollout=True)
    per_env = params.replace(sigma_m=torch.full((16,), 0.1))
    with pytest.raises(NotImplementedError, match="sigma_m"):
        ppo.train_step(env, per_env, cfg, ts, bstate, torch.Generator())
    with pytest.raises(ValueError, match="rollout_noise"):
        ppo.train_step(env, params, cfg, ts, bstate, torch.Generator(),
                       act_noise=torch.zeros(4, 16, 1))


def test_rollout_seed_offset_advances_without_replay():
    gen = torch.Generator().manual_seed(3)
    s1, o1 = ppo_fused.rollout_seed_offset(gen, "cpu", 8)
    s2, o2 = ppo_fused.rollout_seed_offset(gen, "cpu", 8)
    assert s1 != s2 and o1 == o2 == 0 and 0 <= s1 < 1 << 63
    gen = torch.Generator().manual_seed(3)
    assert ppo_fused.rollout_seed_offset(gen, "cpu", 8)[0] == s1


def test_rollout_scalars_reads_the_params():
    _, params = make("fishing-mixture-v1", model_idx=4, Tmax=30, sigma_m=0.2)
    s = ppo_fused.rollout_scalars(params, seed=2**64 - 1, offset=5)
    assert (s.Tmax, s.model_idx, s.seed, s.offset) == (30, 4, 2**64 - 1, 5)
    assert s.K == float(params.K) and s.sigma_m == pytest.approx(0.2)
    with pytest.raises(ValueError, match="unsigned"):
        _seeded("fishing-v1", B=8, seed=-1)


# ------------------------------------------------------- the kernel's limits

@pytest.mark.parametrize("hidden,act_dim,match", [
    (512, 1, "hidden"), (16, 1, "hidden"), (64, 129, "n_actions"), (256, 200, "n_actions")])
def test_check_kernel_limits_refuses(hidden, act_dim, match):
    with pytest.raises(ValueError, match=match):
        pk.check_kernel_limits(hidden, act_dim)


@pytest.mark.parametrize("hidden", pk.KERNEL_HIDDEN)
@pytest.mark.parametrize("act_dim", [1, 3, 16, 100, pk.KERNEL_MAX_ACTIONS])
def test_check_kernel_limits_accepts(hidden, act_dim):
    pk.check_kernel_limits(hidden, act_dim)


def _weights(head, hidden=32):
    env, _ = make("fishing-v1" if head == "gaussian" else "fishing-v0")
    ts = make_train_state(env, ppo.PPOConfig(hidden=hidden), torch.Generator().manual_seed(2))
    return (ppo_fused.kernel_weights(ts.params(), head),
            1 if head == "gaussian" else env.config.n_actions)


@pytest.mark.parametrize("head", ["gaussian", "categorical"])
def test_merge_weights_is_block_diagonal(head):
    """What the wrapper hands the kernel: the cross-tower blocks of W2c and
    Whc are zeros, whatever the towers hold."""
    weights, a = _weights(head)
    merged = uk.merge_weights(tuple(x + 1.0 for x in weights))   # no zero in any tower
    assert len(merged) == 7
    w2c, whc = merged[2], merged[4]
    h = w2c.shape[0] // 2
    for cross in (w2c[:h, h:], w2c[h:, :h], whc[:h, a:], whc[h:, :a]):
        assert cross.numel() and not cross.any()
    for block in (w2c[:h, :h], w2c[h:, h:], whc[:h, :a], whc[h:, a:]):
        assert block.all()


def _call(weights, head, B=8, T=4):
    env, params = make("fishing-v1" if head == "gaussian" else "fishing-v0", sigma=0.1)
    state = (torch.linspace(0.4, 1.1, B), torch.zeros(B, dtype=torch.int32),
             torch.zeros(B), torch.zeros(B), torch.zeros(B, dtype=torch.int32))
    return pk.policy_rollout(*state, weights, ppo_fused.rollout_scalars(params, 3), T,
                             scheme=env.config.scheme, n_actions=env.config.n_actions)


@pytest.mark.parametrize("head", ["gaussian", "categorical"])
@pytest.mark.parametrize("what", ["split", "short", "w2c", "whc"])
def test_wrapper_takes_only_the_split_towers(head, what):
    """The wrapper takes the towers in the merged format only: the 13 split
    arrays, a missing array and an array of another shape are refused."""
    weights, _ = _weights(head)
    merged = uk.merge_weights(weights)
    _call(merged, head)
    if what == "split":
        bad = weights
    elif what == "short":
        bad = merged[:-1]
    else:
        i = 2 if what == "w2c" else 4
        bad = (*merged[:i], merged[i][:-1], *merged[i + 1:])
    with pytest.raises(ValueError, match="7 merged arrays|must be torch.float32 of"):
        _call(bad, head)


def test_wrapper_computes_the_towers_it_is_given():
    """A change in the value tower moves the value row and nothing of the
    policy's; one in the policy tower moves the actions."""
    weights, _ = _weights("gaussian")
    base = _call(uk.merge_weights(weights), "gaussian")
    w2v = weights[9].clone()
    w2v[0, -1] += 0.5
    value = _call(uk.merge_weights((*weights[:9], w2v, *weights[10:])), "gaussian")
    assert torch.equal(base.packed_t[1], value.packed_t[1])          # the actions
    assert not torch.equal(base.packed_t[3], value.packed_t[3])      # the values
    w2p = weights[2].clone()
    w2p[0, -1] += 0.5
    policy = _call(uk.merge_weights((*weights[:2], w2p, *weights[3:])), "gaussian")
    assert not torch.equal(base.packed_t[1], policy.packed_t[1])
    B = 8
    assert torch.equal(base.packed_t[3, :B], policy.packed_t[3, :B])  # the first values


def test_stats_scratch_follows_the_kernels_cta():
    """The wrapper sizes the statistics' scratch by the envs a CTA takes as
    the library exports them for each path (the card test holds that export
    against each path's plan); KERNEL_ENVS_PER_CTA is the narrow kernel's."""
    import inspect

    source = (_build.CSRC / "policy_rollout_kernel.cu").read_text()
    assert f"constexpr int kEnvsPerWarp = {pk.KERNEL_ENVS_PER_CTA // 8};" in source
    assert "constexpr int kThreads = 256;" in source
    assert "extern \"C\" int policy_rollout_envs_per_cta(int hidden, int act_dim, int compute)" \
        in source
    assert "B // lib.policy_rollout_envs_per_cta(hidden, A, p.compute)" in \
        inspect.getsource(pk.policy_rollout)


@pytest.mark.parametrize("hidden", pk.KERNEL_HIDDEN)
@pytest.mark.parametrize("n_cols", ["2H", 8, 104, 128])
def test_frag_index_is_a_bijection(hidden, n_cols):
    """Every entry of a [hidden][N] operand has its own place in the bf16
    copy, and lane t's 8-byte word of column n and k-block kb holds rows
    2t, 2t + 1, 2t + 8, 2t + 9 of the block, in that order."""
    n_cols = 2 * hidden if n_cols == "2H" else n_cols
    k = torch.arange(hidden).repeat_interleave(n_cols)
    n = torch.arange(n_cols).repeat(hidden)
    idx = pk.frag_index(k, n, hidden)
    assert torch.equal(idx.sort().values, torch.arange(hidden * n_cols))
    kb, t, col = 1 if hidden > 16 else 0, 3, n_cols - 1
    word = [pk.frag_index(16 * kb + r, col, hidden) for r in (2 * t, 2 * t + 1, 2 * t + 8,
                                                               2 * t + 9)]
    assert word == [4 * ((col * (hidden // 16) + kb) * 4 + t) + i for i in range(4)]


def _merged_weights(hidden, act_dim, seed=0):
    """Random towers in the merged format, the cross-tower blocks zero."""
    rng = np.random.default_rng(seed)
    merged = [torch.from_numpy(0.3 * rng.standard_normal(shape).astype(np.float32))
              for shape in uk.merged_shapes(1, hidden, act_dim)]
    for i, mask in zip((2, 4), uk._block_diag_masks(hidden, act_dim)):
        merged[i] = merged[i] * mask
    return tuple(merged)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden,act_dim", [(32, 20), (64, 1), (64, 100), (128, 3)])
def test_wide_prep_reference_lays_out_the_merged_weights(hidden, act_dim, compute):
    """The plain version of wide_prep, which the card test holds the kernel's
    regions against bit for bit: each block is the merged weights' (rounded
    under bfloat16), the head is zero in its padding classes, the bf16
    copies hold FW and MP rounded, in fragment order, and W2B the two tower
    blocks rounded, row-major. On a CPU tensor `wide_prep` is this plain
    version."""
    weights = _merged_weights(hidden, act_dim)
    w2c, whc = weights[2:5:2]
    H, A = hidden, act_dim
    rnd = ((lambda x: x.to(torch.bfloat16).float()) if compute == "bfloat16"
           else (lambda x: x))
    prep = pk.wide_prep(weights, compute)
    AP = -(-A // 8) * 8
    fw, gw, mp = prep.fw, prep.gw, prep.mp
    assert fw.shape == gw.shape == (H, 2 * H) and mp.shape == (H, AP)
    for t in range(2):
        block = w2c[t * H:(t + 1) * H, t * H:(t + 1) * H]
        assert torch.equal(fw[:, t * H:(t + 1) * H], rnd(block))
        assert torch.equal(gw[:, t * H:(t + 1) * H], rnd(block).T)
    assert torch.equal(mp[:, :A], rnd(whc[:H, :A])) and not mp[:, A:].any()
    assert torch.equal(prep.mt, mp.T)
    assert torch.equal(prep.wv, rnd(whc[H:, A]))
    assert prep.w2b.dtype == torch.bfloat16 and prep.w2b.shape == (2 * H * H,)
    for t in range(2):
        block = w2c[t * H:(t + 1) * H, t * H:(t + 1) * H]
        assert torch.equal(prep.w2b.view(2, H, H)[t].float(), block.to(torch.bfloat16).float())
    for dense, copy in ((fw, prep.fwb), (mp, prep.mpb)):
        n_cols = dense.shape[1]
        assert copy.dtype == torch.bfloat16 and copy.shape == (H * n_cols,)
        k = torch.arange(H).repeat_interleave(n_cols)
        n = torch.arange(n_cols).repeat(H)
        assert torch.equal(copy[pk.frag_index(k, n, H)].view(H, n_cols).float(),
                           dense.to(torch.bfloat16).float())


# -------------------------------------------------------------------- build

def test_header_edit_changes_the_library_path(tmp_path, monkeypatch):
    """A source that includes csrc/*.cuh is rebuilt when a header changes:
    the library's name hashes every header. No nvcc runs."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = ("rollout_kernel", "ppo_update_kernel", "policy_rollout_kernel")
    before = {n: _build.library_path(n) for n in names}
    assert before == {n: _build.library_path(n) for n in names}   # stable
    header = csrc / "merged_mlp.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    assert not any(p.exists() for p in after.values())


def test_phase_clocks_find_the_narrow_kernel():
    """bench/policy_rollout.py --phases clocks policy_rollout_kernel's entry,
    each step's forward and tail and its end."""
    from gym_fishing_tpu_torch.bench.policy_rollout import WIDE_SECTION, instrument
    from gym_fishing_tpu_torch.kernels import _build

    src = (_build.CSRC / "policy_rollout_kernel.cu").read_text()
    out = instrument(src)
    assert out.split(WIDE_SECTION)[0].count("clock64()") == 6
    assert "sm[L_::STAT + 1] = (float)cyc_fwd;" in out.split(WIDE_SECTION)[0]
    with pytest.raises(RuntimeError, match="wide section"):
        instrument("__global__ void k() {}")


def test_phase_clocks_find_the_wide_kernel():
    """... and policy_rollout_wide's entry, the borders of each step's input
    layer, W2 product, head and value and tail, and its end; a source
    without those anchors is refused."""
    from gym_fishing_tpu_torch.bench.policy_rollout import WIDE_SECTION, instrument
    from gym_fishing_tpu_torch.kernels import _build

    src = (_build.CSRC / "policy_rollout_kernel.cu").read_text()
    wide = instrument(src).split(WIDE_SECTION)[1]
    assert wide.count("clock64()") == 10
    for part in ("cyc_in += m1 - m0;", "cyc_w2 += m2 - m1;", "cyc_head += clock64() - m2;",
                 "cyc_tail += clock64() - c1;", "hv_out[env] = (float)cyc_tail;"):
        assert wide.count(part) == 1
    narrow, old = src.split(WIDE_SECTION)
    with pytest.raises(RuntimeError, match="wide rollout kernel"):
        instrument(narrow + WIDE_SECTION + old.replace("    // the heads:", "    // heads:"))
