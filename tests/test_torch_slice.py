"""The port's main stepping path as a whole, and its boundaries.

- make("fishing-v1") -> escapement -> two chained fused rollouts on the CPU
  (the kernel's plain twin) ≡ the JAX bench's chained `pallas_rollout` in
  interpret mode, at B=1024, T=64. The interpreter draws z = 0, so the twin
  gets zero noise planes.
- `import gym_fishing_tpu_torch` and every submodule leaves JAX out.
- On CPU tensors the kernel wrapper never builds or loads the CUDA library.
- The throughput harness and chip_smoke.py refuse to run without a card.
"""

import dataclasses
import functools
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_fishing_tpu as gft
import gym_fishing_tpu_torch as gtt
from gym_fishing_tpu.agents.policies import escapement as j_escapement
from gym_fishing_tpu.kernels import make_scalars, pallas_rollout
from gym_fishing_tpu_torch.agents.policies import escapement
from gym_fishing_tpu_torch.bench import measure
from gym_fishing_tpu_torch.kernels import _build
from gym_fishing_tpu_torch.kernels import rollout_kernel as rk

# the port's entry points default to the card; these tests run on the CPU
make = functools.partial(gtt.make, device="cpu")

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T = 1024, 64


def test_main_path_two_chained_rollouts_match_jax():
    jenv, jparams = gft.make("fishing-v1")
    jx_star = float(j_escapement(jenv, jparams).x_star)
    scalars = make_scalars(jparams, jx_star, seed=1)
    stock = jnp.full((B,), float(jparams.init_state), jnp.float32)
    t = jnp.zeros((B,), jnp.int32)
    ep = jnp.zeros((B,), jnp.float32)
    jax_out = []
    for _ in range(2):
        out = pallas_rollout(stock, t, scalars, T, rows_per_block=8, growth="logistic",
                             noise_form="additive", ep_ret=ep, interpret=True)
        stock, t, ep = out.stock, out.t, out.ep_ret
        jax_out.append(out)

    env, params = make("fishing-v1")
    x_star = float(escapement(env, params).x_star)
    assert x_star == jx_star
    stock = torch.full((B,), float(params.init_state))
    t = torch.zeros(B, dtype=torch.int32)
    ep = torch.zeros(B)
    zeros = torch.zeros((1, T, B))
    for jo in jax_out:
        out = rk.rollout(stock, t, params, "escapement", x_star, T,
                         growth=env.config.growth, noise_form=env.config.noise_form,
                         ep_ret=ep, noise=zeros)
        stock, t, ep = out.stock, out.t, out.ep_ret
        np.testing.assert_allclose(out.stock.numpy(), np.asarray(jo.stock), atol=2e-6)
        np.testing.assert_array_equal(out.t.numpy(), np.asarray(jo.t))
        np.testing.assert_allclose(out.reward.numpy(), np.asarray(jo.reward), atol=2e-5)
        np.testing.assert_allclose(out.ep_ret_sum.numpy(), np.asarray(jo.ep_ret_sum), atol=2e-5)
        np.testing.assert_allclose(out.ep_ret.numpy(), np.asarray(jo.ep_ret), atol=2e-5)
        np.testing.assert_array_equal(out.ep_count.numpy(), np.asarray(jo.ep_count))
    # 128 steps with Tmax = 100: the second call finishes each env's episode
    assert bool((out.ep_count == 1).all()) and bool((out.t == 2 * T - 100).all())


def test_port_imports_no_jax():
    code = (
        "import pkgutil, sys, importlib\n"
        "import gym_fishing_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'gym_fishing_tpu'))\n"
        "assert len(names) >= 70, names\n"
        "for n in ('agents.a2c', 'agents.dp', 'agents.es', 'examples.simulate_baselines',\n"
        "          'examples.tipping_point', 'examples.model_uncertainty',\n"
        "          'examples.dp_optimal', 'agents.ppo_rnn', 'agents.sac', 'agents.dqn',\n"
        "          'agents.td3', 'agents.sb3_like', 'examples.pomdp_policies',\n"
        "          'examples.train_ppo', 'shard', 'shard.mesh', 'shard.fused_ppo',\n"
        "          'shard.launch', 'kernels.sharded', 'bench.scaling',\n"
        "          'examples.multihost_train'):\n"
        "    assert pkg.__name__ + '.' + n in names, n\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_cpu_wrapper_never_loads_the_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f"tried to build/load {name}")

    monkeypatch.setattr(_build, "load", refuse)
    env, params = make("fishing-v1")
    before = rk.launches
    out = rk.rollout(torch.full((40,), 0.75), torch.zeros(40, dtype=torch.int32), params,
                     "escapement", 0.5, 8, seed=1)
    z = rk.philox_normals(1, 0, 40, "cpu")
    assert out.stock.shape == (40,) and z.shape == (4, 40)
    assert rk.launches == before
    assert "rollout_kernel" not in _build._LIBS


@pytest.mark.parametrize("mode", ["engine", "kernel"])
def test_measure_runs_on_cpu_when_asked(mode):
    res = measure(mode=mode, num_envs=128, num_steps=8, iters=2, warmup=1, device="cpu")
    assert res["device"] == "cpu" and res["mode"] == mode
    assert res["steps_per_s"] > 0 and np.isfinite(res["reward_sum"]) and res["reward_sum"] > 0


def test_measure_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure(mode="kernel", num_envs=128, num_steps=8)
    with pytest.raises(ValueError, match="unknown mode"):
        measure(mode="xla", device="cpu")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result line on a machine
    without CUDA, and in a directory that holds nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_params_from_numpy_round_trips_jax_params():
    from gym_fishing_tpu_torch.convert import params_from_numpy

    _, jp = gft.make("fishing-mixture-v1", dtype=jnp.float32, model_idx=4, Tmax=30)
    fields = {f.name: np.asarray(getattr(jp, f.name)) for f in dataclasses.fields(jp)}
    tp = params_from_numpy(fields, torch.float32, "cpu")
    _, ref = make("fishing-mixture-v1", model_idx=4, Tmax=30)
    for f in dataclasses.fields(tp):
        a, b = getattr(tp, f.name), getattr(ref, f.name)
        assert a.dtype == b.dtype and float(a) == float(b), f.name
    with pytest.raises(KeyError, match="missing"):
        params_from_numpy({"r": np.float32(0.3)})
