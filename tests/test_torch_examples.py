"""The port's examples (gym_fishing_tpu_torch/examples/), each run as
``python -m gym_fishing_tpu_torch.examples.<name> --device cpu`` at the
small sizes tests/test_examples.py gives the JAX scripts: exit 0 and the
artifacts exist. train_ppo runs plain, as A2C and as fused full + fused
Adam (the kernels' twins on the CPU; these two through `main` in the test's
process); its checkpoint loads back into the facade; ``--shuffle affine``
fails as PPOConfig(shuffle="affine") does.
The tipping point's stocks are also held against JAX's
batch `rollout` from the same initial stocks: both run the May model's
float32 operations without noise, in another order, so over 40 steps they
agree to a few float32 roundings of a stock below 2 (2e-6).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_fishing_tpu as gft
import gym_fishing_tpu_torch as gtt
from gym_fishing_tpu.batch import batched_reset as j_batched_reset
from gym_fishing_tpu.batch import rollout as j_rollout
from gym_fishing_tpu_torch.examples import train_ppo
from gym_fishing_tpu_torch.examples.dp_optimal import dp_report
from gym_fishing_tpu_torch.examples.tipping_point import basin_stocks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def _run(name, *args, timeout=300):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", f"gym_fishing_tpu_torch.examples.{name}", *map(str, args),
         "--device", "cpu"],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT,
    )
    assert proc.returncode == 0, (
        f"{name} exited {proc.returncode}\nstdout:\n{proc.stdout[-2000:]}"
        f"\nstderr:\n{proc.stderr[-2000:]}"
    )
    assert "jax" not in proc.stderr.lower()
    return proc


def test_dp_optimal_example(tmp_path):
    out = tmp_path / "dp.png"
    proc = _run("dp_optimal", "--reps", 2, "--n-states", 65, "--n-quotas", 33, "--out", out)
    assert out.exists()
    assert "value iteration:" in proc.stdout and "escapement" in proc.stdout


def test_simulate_baselines_example(tmp_path):
    out = tmp_path / "results"
    proc = _run("simulate_baselines", "--out", out, "--reps", 2)
    assert (out / "fishing-v1_escapement.csv").exists()
    assert (out / "fishing-v1_msy.png").exists()
    assert len(list(out.iterdir())) == 2 * 2 * len(gft.registered_ids())
    assert proc.stdout.count("mean return") == 2 * len(gft.registered_ids())


def test_tipping_point_example(tmp_path):
    out = tmp_path / "may_basins.png"
    _run("tipping_point", "--out", out, "--horizon", 20)
    assert out.exists()


def test_model_uncertainty_example():
    proc = _run("model_uncertainty", "--num-envs", 64, "--horizon", 8, "--steps", 3)
    assert "steps: 1,536" in proc.stdout and "active growth models" in proc.stdout


def test_tipping_point_stocks_match_jax_rollout():
    B, horizon = 64, 40
    x0 = np.linspace(0.01, 1.0, B).astype(np.float32)
    env, params = gft.make("fishing-may-v1", sigma=0.0, Tmax=10_000)
    state = j_batched_reset(env, params, B)
    state = state.replace(env=state.env.replace(stock=jnp.asarray(x0, params.dtype)))
    policy = lambda obs, k: jnp.full((B, 1), -1.0, params.dtype)  # noqa: E731
    _, traj = j_rollout(env, params, policy, state, jax.random.key(0), horizon,
                        autoreset=False)
    want = (np.asarray(traj.obs[..., 0]) + 1.0) * float(params.K)
    got = basin_stocks(torch.from_numpy(x0), horizon, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    # both basins are reached: the sweep crosses the unstable equilibrium
    assert (got[-1] > 0.3).any() and (got[-1] < 0.3).any()


@pytest.mark.parametrize("env_id", ["fishing-v1", "fishing-may-v1"])
def test_dp_report_orders_the_policies(env_id):
    """The DP policy's exact value at the initial stock is at least each
    baseline's (it is optimal on the discretized MDP)."""
    sol, _, rows = dp_report(env_id, sigma=0.05, gamma=0.99, n_states=65, n_quotas=33,
                             reps=2, device="cpu")
    v_dp = rows["dp"][2]
    assert all(v_dp >= v - 1e-4 for _, _, v in rows.values())
    assert sol.iterations > 0 and np.isfinite(v_dp)


def test_pomdp_policies_example():
    proc = _run("pomdp_policies", "--iterations", 2, "--num-envs", 64, "--reps", 2, "--k", 3)
    for name in ("PPO raw obs", "PPO 3-step window", "recurrent PPO (GRU)", "escapement"):
        assert name in proc.stdout
    assert proc.stdout.count("mean return") == 4


def _train_ppo_args(out, steps):
    return ["--timesteps", 64 * steps, "--num-envs", 64, "--num-steps", steps, "--out", out,
            "--device", "cpu"]


@pytest.mark.parametrize("flags", [(), ("--algo", "a2c"), ("--fused", "full", "--fused-adam")])
def test_train_ppo_example(tmp_path, capsys, flags):
    """At tests/test_examples.py's sizes; the fused form at 16 steps, as the
    fused update takes minibatches of a multiple of 128 samples (64 x 16 /
    8). The plain form runs as a module in its own process, the other two
    through its `main` here (fewer interpreters beside the suite's other
    workers)."""
    out = tmp_path / "ppo"
    steps = 16 if "--fused" in flags else 8
    if flags:
        train_ppo.main([str(a) for a in _train_ppo_args(out, steps)] + list(flags))
        stdout = capsys.readouterr().out
    else:
        stdout = _run("train_ppo", *_train_ppo_args(out, steps)[:-2]).stdout
    for artifact in ("ckpt", "sim.csv", "policy.png", "mdp.png"):
        assert (out / artifact).exists(), f"missing {artifact}"
    assert "mean episode return" in stdout and "escapement=" in stdout
    from gym_fishing_tpu_torch.agents import A2C, PPO

    kw = dict(num_envs=64, num_steps=steps, device="cpu")
    if "a2c" in flags:
        model = A2C.load(str(out / "ckpt"), env=gtt.make("fishing-v1", sigma=0.05, device="cpu"),
                         **kw)
    else:
        fused = dict(fused_update=True, fused_rollout=True, fused_adam=True) if flags else {}
        model = PPO.load(str(out / "ckpt"), env=gtt.make("fishing-v1", sigma=0.05, device="cpu"),
                         **kw, **fused)
    assert model.num_timesteps == 64 * steps


def test_train_ppo_example_refuses_the_affine_shuffle(tmp_path):
    with pytest.raises(NotImplementedError, match="not ported"):
        train_ppo.main([str(a) for a in _train_ppo_args(tmp_path / "ppo", 8)]
                       + ["--shuffle", "affine"])
