"""The port's gym surfaces (envs/gym_adapter.py, vector_env.py,
gymnasium_compat.py, gym_registration.py).

- gymnasium's env checker passes for every registered id.
- terminated (a collapse) and truncated (the horizon) are told apart, also
  for a collapse on exactly the Tmax-th step.
- The stateful adapter keeps the reference attributes, and its ``file=``
  CSV log equals the JAX adapter's on a noise-free episode.
"""

import functools

import numpy as np
import pytest
import torch

gymnasium = pytest.importorskip("gymnasium")

import gym_fishing_tpu_torch as gtt  # noqa: E402
import gym_fishing_tpu_torch.envs.gymnasium_compat as compat  # noqa: E402
from gym_fishing_tpu.envs.gym_adapter import GymFishingEnv as JGymFishingEnv  # noqa: E402
from gym_fishing_tpu_torch.agents.policies import msy  # noqa: E402
from gym_fishing_tpu_torch.envs import FishingVectorEnv, GymFishingEnv  # noqa: E402
from gym_fishing_tpu_torch.registry import registered_ids  # noqa: E402

VectorEnv = functools.partial(FishingVectorEnv, device="cpu")

torch.set_num_threads(1)


def _make(env_id, **kw):
    return gymnasium.make(f"{compat.NAMESPACE}/{env_id}", **kw).unwrapped


@pytest.mark.parametrize("env_id", registered_ids())
def test_env_checker(env_id):
    from gymnasium.utils.env_checker import check_env

    env = _make(env_id)
    assert isinstance(env, compat.GymnasiumFishingEnv)
    check_env(env, skip_render_check=True)


def test_all_26_ids_are_registered():
    ids = registered_ids()
    assert len(ids) == 26
    assert all(f"{compat.NAMESPACE}/{i}" in gymnasium.registry for i in ids)


def test_terminated_vs_truncated():
    env = _make("fishing-v1", sigma=0.0)
    env.reset(seed=0)
    obs, r, term, trunc, info = env.step(np.asarray([1.0], np.float32))   # harvest it all
    assert term and not trunc and obs.dtype == np.float32
    env2 = _make("fishing-v1", sigma=0.0, Tmax=3)
    env2.reset(seed=0)
    for _ in range(3):
        obs, r, term, trunc, info = env2.step(np.asarray([-1.0], np.float32))
    assert trunc and not term and "harvest" in info and "stock" in env2.render()


def test_vector_env():
    envs = VectorEnv("fishing-v1", num_envs=8, sigma=0.0, Tmax=4)
    obs, infos = envs.reset(seed=0)
    assert obs.shape == (8, 1) and obs.dtype == np.float32
    assert envs.single_observation_space.shape == (1,) and envs.action_space.shape == (8, 1)
    for _ in range(4):
        obs, rew, term, trunc, infos = envs.step(np.full((8, 1), -0.95, np.float32))
    assert trunc.all() and not term.any()
    assert (infos["episode_length"] == 4).all() and infos["episode_return"].shape == (8,)
    envs2 = VectorEnv("fishing-v1", num_envs=4, sigma=0.0)
    envs2.reset(seed=0)
    obs, rew, term, trunc, infos = envs2.step(np.full((4, 1), 1.0, np.float32))
    assert term.all() and not trunc.any()


def test_vector_env_collapse_at_horizon_is_terminated():
    envs = VectorEnv("fishing-v1", num_envs=4, sigma=0.0, Tmax=2)
    envs.reset(seed=0)
    envs.step(np.full((4, 1), -1.0, np.float32))
    obs, rew, term, trunc, infos = envs.step(np.full((4, 1), 1.0, np.float32))
    assert term.all() and not trunc.any() and (infos["episode_length"] == 2).all()


def test_vector_env_discrete_and_seeded():
    envs = VectorEnv("fishing-v0", num_envs=4, sigma=0.1)
    assert envs.single_action_space.n == 3
    runs = []
    for _ in range(2):
        envs.reset(seed=3)
        runs.append([envs.step(np.array([0, 1, 2, 0]))[1] for _ in range(5)])
    assert runs[0][0].shape == (4,)
    np.testing.assert_array_equal(np.stack(runs[0]), np.stack(runs[1]))


def test_vector_env_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FishingVectorEnv("fishing-v1", num_envs=4)


def test_gym_adapter_roundtrip(tmp_path):
    env = GymFishingEnv("fishing-v1", sigma=0.05, seed=1)
    obs = env.reset()
    assert obs.shape == (1,) and -1 <= obs[0] <= 1
    for _ in range(10):
        obs, reward, done, info = env.step(np.asarray([-0.9]))
        assert "harvest" in info and "quota" in info and not done
    assert env.years_passed == 10 and env.fish_population > 0 and "stock" in env.render()
    a = env.get_action(0.3)
    assert env.get_quota(a) == pytest.approx(0.3, abs=1e-6)
    assert env.get_fish_population(env.get_obs()) == pytest.approx(env.fish_population,
                                                                    rel=1e-6)
    df = env.simulate(msy(env.env, env.params), reps=2, file=str(tmp_path / "sim.csv"))
    assert (tmp_path / "sim.csv").exists() and df.rep.nunique() == 2
    env.plot(df, str(tmp_path / "sim.png"))
    env.plot_policy(env.policyfn(msy(env.env, env.params), n=10), str(tmp_path / "pol.png"))
    assert (tmp_path / "sim.png").exists() and (tmp_path / "pol.png").exists()


def test_gym_adapter_discrete_and_seeded():
    env = GymFishingEnv("fishing-v0", sigma=0.0)
    obs, reward, done, info = env.step(1)  # +20%
    assert env.harvest == pytest.approx(0.0125 * 1.2, rel=1e-5)
    noisy = GymFishingEnv("fishing-v1", sigma=0.1, seed=4)
    first = [noisy.step(np.asarray([-0.5]))[1] for _ in range(3)]
    noisy.reset(seed=4)
    assert [noisy.step(np.asarray([-0.5]))[1] for _ in range(3)] == first


@pytest.mark.parametrize("env_id,action", [("fishing-v1", [-0.5]), ("fishing-v0", 2)])
def test_file_log_matches_jax(tmp_path, env_id, action):
    """The reference's per-step CSV rows [time, state, action, reward, rep],
    rep counting resets, equal the JAX adapter's on noise-free episodes."""
    logs = {}
    for name, cls in (("port", GymFishingEnv), ("jax", JGymFishingEnv)):
        path = tmp_path / f"{name}.csv"
        env = cls(env_id, sigma=0.0, file=str(path))
        for _ in range(5):
            env.step(np.asarray(action) if env_id == "fishing-v1" else action)
        env.reset()
        env.step(np.asarray(action) if env_id == "fishing-v1" else action)
        env.close()
        logs[name] = path.read_text().splitlines()
    assert logs["port"][0] == logs["jax"][0] == "time,state,action,reward,rep"
    assert len(logs["port"]) == len(logs["jax"]) == 7
    port = np.array([[float(x) for x in r.split(",")] for r in logs["port"][1:]])
    jax_ = np.array([[float(x) for x in r.split(",")] for r in logs["jax"][1:]])
    np.testing.assert_allclose(port, jax_, rtol=1e-6, atol=1e-7)
    assert list(port[:, 4]) == [0, 0, 0, 0, 0, 1]


def test_legacy_gym_shim_degrades_gracefully():
    import gym_fishing_tpu_torch.envs.gym_registration as reg

    try:
        import gym  # noqa: F401
    except ImportError:
        assert reg.REGISTERED is False and reg.register_with_gym() is False
    else:
        assert reg.REGISTERED is True
    env = reg.LegacyGymFishingEnv("fishing-v0", sigma=0.0)
    env.reset()
    obs, reward, done, info = env.step(1)
    assert not done and "harvest" in info and obs.shape == (1,)


def test_port_gym_modules_import_no_pandas_or_gymnasium_eagerly():
    """The card has neither pandas, matplotlib nor gymnasium: the adapters
    and the simulate module import them only where they are used."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "for m in ('pandas', 'matplotlib', 'gymnasium'):\n"
        "    sys.modules[m] = None\n"
        "from gym_fishing_tpu_torch.envs import GymFishingEnv, FishingVectorEnv\n"
        "from gym_fishing_tpu_torch.analysis.simulate import _simulate_steps\n"
        "import gym_fishing_tpu_torch.analysis, gym_fishing_tpu_torch.utils.checkpoint\n"
        "e = FishingVectorEnv('fishing-v1', num_envs=4, device='cpu')\n"
        "assert not hasattr(e, 'single_action_space')\n"
        "g = GymFishingEnv('fishing-v1'); g.step([-0.5])\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
    _ = gtt   # the package itself imports none of them either
