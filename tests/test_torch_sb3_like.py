"""The port's sb3-style facades (agents/sb3_like.py) and this slice's entry
points.

- `_resolve_env` takes an id, an `Env`, an (env, params) tuple or a gym
  adapter.
- Each facade learns, predicts, saves and loads at tests/test_sb3_like.py's
  sizes; a loaded model that learns on is bit-identical to the one that
  never stopped (weights, optimizer moments and counts, targets, the replay
  buffer, the batch state, the generator and the metrics).
- The PPO facade with fused_update, fused_rollout and fused_adam (the
  kernels' twins on the CPU) ≡ the same facade with the fused flags off
  after one iteration at 1 epoch x 1 minibatch from the same draws (1e-5).
- Facade-trained policies run through simulate_mdp.
- Every entry point this slice adds runs on the card by default: without a
  card it raises, naming device="cpu", and with device="cpu" it works.
"""

import functools

import numpy as np
import pytest
import torch

import gym_fishing_tpu_torch as gtt
from gym_fishing_tpu_torch.agents import (
    A2C, DQN, PPO, SAC, TD3, dqn, ppo_fused, ppo_rnn, sac, td3,
)
from gym_fishing_tpu_torch.agents.sb3_like import _resolve_env
from gym_fishing_tpu_torch.analysis import simulate_mdp
from gym_fishing_tpu_torch.envs.gym_adapter import GymFishingEnv
from gym_fishing_tpu_torch.utils.checkpoint import _flatten

make = functools.partial(gtt.make, device="cpu")

torch.set_num_threads(1)

OFF_POLICY = dict(num_envs=16, buffer_size=1024, batch_size=64)
FACADES = {
    "ppo": (PPO, "fishing-v1", dict(num_envs=64, num_steps=16, epochs=2, num_minibatches=2),
            64 * 16),
    "ppo full+adam": (PPO, "fishing-v1",
                      dict(num_envs=64, num_steps=32, epochs=2, num_minibatches=1,
                           fused_update=True, fused_rollout=True, fused_adam=True), 64 * 32),
    "a2c": (A2C, "fishing-v0", dict(num_envs=64, num_steps=16), 64 * 16),
    "sac": (SAC, "fishing-v1", OFF_POLICY, 16),
    "td3": (TD3, "fishing-v1", OFF_POLICY, 16),
    "dqn": (DQN, "fishing-v0", OFF_POLICY, 16),
}


def _leaves(model):
    """Every leaf of the facade's training tuple, generator state included."""
    tree = dict(model._checkpoint_tree(), generator=model.generator,
                num_timesteps=model.num_timesteps)
    return {k: (v.get_state() if isinstance(v, torch.Generator) else v)
            for k, v in _flatten(tree)}


def _assert_identical(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        if isinstance(la[k], torch.Tensor):
            assert la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]), k
        else:
            assert la[k] == lb[k], k


def test_resolve_env_takes_four_forms():
    env, params = _resolve_env("fishing-v0", "cpu")
    assert env.config.scheme == "relative" and params.device.type == "cpu"
    env2, params2 = _resolve_env(env, "cpu")
    assert env2 is env and float(params2.K) == float(params.K)
    tup = make("fishing-v1", sigma=0.3)
    assert _resolve_env(tup) == tup
    gym_env = GymFishingEnv("fishing-v1", sigma=0.2)
    env3, params3 = _resolve_env(gym_env)
    assert env3 is gym_env.env and params3 is gym_env.params
    assert float(params3.sigma) == pytest.approx(0.2)
    with pytest.raises(TypeError):
        _resolve_env(3)
    with pytest.raises(ValueError, match="MlpPolicy"):
        PPO("CnnPolicy", "fishing-v1", device="cpu")


@pytest.mark.parametrize("name", sorted(FACADES))
def test_facade_learn_predict_save_load_resumes_bit_for_bit(tmp_path, name):
    cls, env_id, kw, per_step = FACADES[name]
    model = cls("MlpPolicy", env_id, seed=3, device="cpu", **kw)
    steps = 3 if cls in (PPO, A2C) else 30
    model.learn(total_timesteps=per_step * steps)
    assert model.num_timesteps == per_step * steps and len(model.history) == steps
    obs = np.zeros((5, 1), np.float32)
    action, state = model.predict(obs)
    if env_id == "fishing-v1":
        assert action.shape == (5, 1)
    else:
        assert action.shape == (5,) and action.dtype == np.int32
        assert np.all((action >= 0) & (action < 3))
        if cls is DQN:   # relative scheme: the state slot carries the harvest
            assert state is not None and state.shape == (5,)

    model.save(str(tmp_path / name))
    loaded = cls.load(str(tmp_path / name), env=env_id, device="cpu", **kw)
    assert loaded.num_timesteps == model.num_timesteps
    _assert_identical(loaded, model)
    np.testing.assert_array_equal(loaded.predict(obs)[0], action)
    model.learn(total_timesteps=per_step * 2)
    loaded.learn(total_timesteps=per_step * 2)
    _assert_identical(loaded, model)
    got, want = loaded.history, model.history[-2:]
    assert [h.keys() for h in got] == [h.keys() for h in want]
    assert all(np.array_equal(list(g.values()), list(w.values()), equal_nan=True)
               for g, w in zip(got, want))


def test_ppo_facade_fused_matches_plain_after_one_iteration():
    """full + fused_adam (K4 and K3's twins) ≡ off at 1 epoch x 1
    minibatch, the plain rollout and the kernel fed the same draws."""
    B, T = 64, 32
    kw = dict(num_envs=B, num_steps=T, epochs=1, num_minibatches=1, hidden=32)
    plain = PPO("MlpPolicy", "fishing-v1", seed=5, device="cpu", **kw)
    fused = PPO("MlpPolicy", "fishing-v1", seed=5, device="cpu", fused_update=True,
                fused_rollout=True, fused_adam=True, **kw)
    assert fused.env_params.device.type == "cpu"
    for p, q in zip(plain.train_state.model.parameters(), fused.train_state.model.parameters()):
        assert torch.equal(p, q)
    rng = np.random.default_rng(6)
    act = torch.from_numpy(rng.standard_normal((T, B, 1)).astype(np.float32))
    env_n = torch.from_numpy(rng.standard_normal((T, 2, B)).astype(np.float32))
    m_plain = plain.train_iteration(perms=[torch.arange(B * T)], act_noise=act,
                                    env_noise=env_n)
    m_fused = fused.train_iteration(
        perms=[torch.zeros(1, dtype=torch.int32)],
        rollout_noise=ppo_fused.rollout_noise_from_draws(act, env_n, 0.0, False))
    for (name, p), q in zip(plain.train_state.model.named_parameters(),
                            fused.train_state.model.parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    for name in ("loss", "pg_loss", "v_loss", "entropy", "episode_return"):
        np.testing.assert_allclose(m_fused[name], m_plain[name], rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    assert fused.train_state.count == plain.train_state.count == 1


def test_facade_policies_run_through_simulate_mdp():
    model = PPO("MlpPolicy", "fishing-v0", num_envs=32, num_steps=8, epochs=1,
                num_minibatches=2, device="cpu")
    model.learn(total_timesteps=32 * 8)
    env, params = make("fishing-v0", Tmax=20)
    assert len(simulate_mdp(env, model, reps=2, params=params)) == 40   # .predict loop
    assert len(simulate_mdp(env, model.policy, reps=2, params=params)) == 40   # device path
    for cls, env_id in ((SAC, "fishing-v1"), (TD3, "fishing-v1"), (DQN, "fishing-v0")):
        m = cls("MlpPolicy", env_id, device="cpu", **OFF_POLICY)
        m.learn(total_timesteps=16 * 3)
        env, params = make(env_id, Tmax=15)
        df = simulate_mdp(env, m.policy, reps=2, params=params)
        assert len(df) == 30 and np.isfinite(df.reward).all()


def _env(env_id="fishing-v1"):
    return make(env_id)[0]


RCFG = ppo_rnn.RPPOConfig(num_envs=8, num_steps=4, epochs=1, num_minibatches=2, hidden=16)
ENTRY_POINTS = {
    "PPO": lambda device: PPO("MlpPolicy", "fishing-v1", num_envs=8, num_steps=4,
                              device=device).train_state.model,
    "SAC": lambda device: SAC("MlpPolicy", "fishing-v1", device=device, **OFF_POLICY).state.actor,
    "DQN": lambda device: DQN("MlpPolicy", device=device, **OFF_POLICY).state.q,
    "make_rppo_state": lambda device: ppo_rnn.make_rppo_state(_env(), RCFG,
                                                              device=device).model,
    "rppo_train": lambda device: ppo_rnn.train(_env(), RCFG, iterations=1,
                                               device=device)[0].model,
    "make_sac_state": lambda device: sac.make_sac_state(
        _env(), sac.SACConfig(num_envs=8, buffer_size=64), device=device).critic,
    "sac_train": lambda device: sac.sac_train(
        _env(), sac.SACConfig(num_envs=8, buffer_size=64, batch_size=8), steps=1,
        device=device)[0].actor,
    "make_td3_state": lambda device: td3.make_td3_state(
        _env(), td3.TD3Config(num_envs=8, buffer_size=64), device=device).actor,
    "td3_train": lambda device: td3.td3_train(
        _env(), td3.TD3Config(num_envs=8, buffer_size=64, batch_size=8), steps=1,
        device=device)[0].critic,
    "make_dqn_state": lambda device: dqn.make_dqn_state(
        _env("fishing-v0"), dqn.DQNConfig(num_envs=8, buffer_size=64), device=device).q,
    "dqn_train": lambda device: dqn.dqn_train(
        _env("fishing-v0"), dqn.DQNConfig(num_envs=8, buffer_size=64, batch_size=8), steps=1,
        warmup_steps=1, device=device)[0].q,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name](None)
    module = ENTRY_POINTS[name]("cpu")
    assert all(p.device.type == "cpu" for p in module.parameters())
