"""The port's checkpoint/resume (utils/checkpoint.py), debug helpers
(utils/debug.py) and the agreement gate (validation/fused_training.py).

Resume is exact: a run saved after 2 iterations and restored into a fresh
state and fresh generators continues bit for bit as the run that never
stopped, in the plain (`off`) form and in the fully fused form with the
in-kernel Adam (`full+adam`, whose kernels run as their twins on the CPU),
and with a StackedState in the batch state.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import gym_fishing_tpu_torch as gtt
from gym_fishing_tpu_torch.agents import ppo
from gym_fishing_tpu_torch.batch import batched_reset
from gym_fishing_tpu_torch.envs.wrappers import StackedState, stack_observations
from gym_fishing_tpu_torch.utils import checkpoint as ckpt
from gym_fishing_tpu_torch.utils import debug

# the port's entry points default to the card; these tests run on the CPU
make = functools.partial(gtt.make, device="cpu")
make_train_state = functools.partial(ppo.make_train_state, device="cpu")

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FORMS = {
    "off": dict(),
    "full+adam": dict(fused_update=True, fused_rollout=True, fused_adam=True),
    "stacked update+adam": dict(fused_update=True, fused_adam=True),
}


def _setup(form, seed=0):
    """(env, params, cfg, training tuple) at a CPU size."""
    env, params = make("fishing-may-obs-v1" if form.startswith("stacked") else "fishing-v1",
                       sigma=0.1)
    if form.startswith("stacked"):
        env = stack_observations(env, 4)
    cfg = ppo.PPOConfig(num_envs=32, num_steps=16, epochs=2, num_minibatches=2, hidden=32,
                        ent_coef=0.01, **FORMS[form])
    ts = make_train_state(env, cfg, torch.Generator().manual_seed(seed))
    tup = {"train_state": ts, "batch": batched_reset(env, params, cfg.num_envs),
           "generator": torch.Generator().manual_seed(seed + 1)}
    return env, params, cfg, tup


def _iterate(env, params, cfg, tup, n):
    ts, bstate, gen = tup["train_state"], tup["batch"], tup["generator"]
    mets = []
    for _ in range(n):
        ts, bstate, met = ppo.train_step(env, params, cfg, ts, bstate, gen)
        mets.append({k: float(v) for k, v in met.items()})
    return dict(tup, train_state=ts, batch=bstate), mets


def _flat(tup):
    """Every tensor and number of the training tuple, by path."""
    ts = tup["train_state"]
    out = {f"model/{k}": v.detach() for k, v in ts.model.named_parameters()}
    out.update({f"m/{k}": v for k, v in ts.m.items()})
    out.update({f"v/{k}": v for k, v in ts.v.items()})
    out.update({"count": torch.tensor(ts.count), "step": torch.tensor(ts.step),
                "generator": tup["generator"].get_state()})
    bs = tup["batch"]
    env_state = bs.env.env if isinstance(bs.env, StackedState) else bs.env
    out.update({"stock": env_state.stock, "harvest": env_state.harvest, "t": env_state.t,
                "ret": bs.episode_return, "len": bs.episode_length})
    if isinstance(bs.env, StackedState):
        out["window"] = bs.env.window
    return out


def _assert_bitwise(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("form", list(FORMS))
def test_resume_equals_never_stopping(tmp_path, form):
    env, params, cfg, tup = _setup(form)
    tup, _ = _iterate(env, params, cfg, tup, 2)
    ckpt.save_checkpoint(str(tmp_path), tup, step=2)
    straight, mets = _iterate(env, params, cfg, tup, 2)

    _, _, _, fresh = _setup(form, seed=9)   # other weights and generators
    restored, step = ckpt.restore_checkpoint(str(tmp_path), fresh)
    assert step == 2
    resumed, mets_r = _iterate(env, params, cfg, restored, 2)
    _assert_bitwise(resumed, straight)
    assert mets_r == mets
    if form.startswith("stacked"):
        assert resumed["batch"].env.window.shape == (cfg.num_envs, 4)


def test_round_trip_preserves_the_training_tuple(tmp_path):
    env, params, cfg, tup = _setup("stacked update+adam")
    tup, _ = _iterate(env, params, cfg, tup, 1)
    fname = ckpt.save_checkpoint(str(tmp_path), tup, step=7)
    assert os.path.exists(fname) and os.path.exists(tmp_path / "ckpt_7.meta.json")
    assert ckpt.latest_step(str(tmp_path)) == 7
    ckpt.save_checkpoint(str(tmp_path), tup, step=11)
    assert ckpt.latest_step(str(tmp_path)) == 11
    back, step = ckpt.restore_checkpoint(str(tmp_path), _setup("stacked update+adam", 5)[3],
                                         step=7)
    assert step == 7
    _assert_bitwise(back, tup)
    assert back["train_state"].model is not tup["train_state"].model
    assert isinstance(back["batch"].env, StackedState)
    meta = json.loads((tmp_path / "ckpt_7.meta.json").read_text())
    assert meta["generator_paths"] == ["generator"]


def test_mismatches_and_backends_raise(tmp_path):
    _, _, _, tup = _setup("off")
    ckpt.save_checkpoint(str(tmp_path), tup)
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore_checkpoint(str(tmp_path), {"batch": tup["batch"]})
    small = _setup("off")[3]
    small["batch"] = batched_reset(*make("fishing-v1"), 8)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_checkpoint(str(tmp_path), small)
    wide = dict(tup, train_state=ppo.make_train_state(
        make("fishing-v1")[0], ppo.PPOConfig(hidden=16), torch.Generator(), device="cpu"))
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_checkpoint(str(tmp_path), wide)
    for call in (lambda: ckpt.save_checkpoint(str(tmp_path), tup, backend="orbax"),
                 lambda: ckpt.restore_checkpoint(str(tmp_path), tup, backend="orbax"),
                 lambda: ckpt.latest_step(str(tmp_path), backend="orbax")):
        with pytest.raises(ValueError, match="npz"):
            call()
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        ckpt.save_checkpoint(str(tmp_path), tup, backend="zarr")
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), tup)
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_debug_helpers():
    debug.assert_unique_keys(torch.tensor([[1, 0], [1, 4], [2, 0]]))
    with pytest.raises(AssertionError, match="1 duplicate"):
        debug.assert_unique_keys(torch.tensor([[1, 4], [2, 0], [1, 4]]))
    _, _, _, tup = _setup("stacked update+adam")
    a = debug.trajectory_checksum(tup["batch"])
    bs = tup["batch"]
    want = sum(float(x.double().sum()) for x in (
        bs.env.env.stock, bs.env.env.harvest, bs.env.env.t, bs.env.window, bs.episode_return,
        bs.episode_length))
    assert a == pytest.approx(want, rel=1e-12)
    debug.assert_finite(tup["batch"])
    bad = dataclasses.replace(bs, episode_return=bs.episode_return.clone().fill_(float("nan")))
    with pytest.raises(AssertionError, match="episode_return contains non-finite"):
        debug.assert_finite(bad, name="batch")
    with pytest.raises(AssertionError, match="non-finite"):
        debug.assert_finite({"x": np.array([1.0, np.inf])})


def test_validator_runs_two_iterations_on_the_cpu():
    cmd = [sys.executable, "-m", "gym_fishing_tpu_torch.validation.fused_training",
           "--device", "cpu", "--iterations", "2", "--num-envs", "64", "--num-steps", "32",
           "--agreement", "--fused-adam", "--chain-shortening", "--threshold", "-100"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    line, verdict = proc.stdout.strip().splitlines()[-2:]
    out = json.loads(line)
    assert verdict == "PASS" and out["pass"] and out["iterations"] == 2
    assert out["env_steps"] == 2 * 64 * 32 and out["agreement"]["fused"] == []
    proc = subprocess.run(cmd[:-2] + ["--threshold", "100"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 1 and proc.stdout.strip().endswith("FAIL")
