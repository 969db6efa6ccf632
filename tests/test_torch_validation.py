"""The recorded JAX learning curve that the port's training run is held
against (``gym_fishing_tpu_torch/validation/jax_curve_fishing_v1.json``),
and its recorder.

The card's machine has no JAX, so the curve of JAX's plain PPO train step
(fishing-v1, sigma 0.05, ``PPOConfig(num_envs=4096, num_steps=128)`` with its
defaults of 4 epochs x 8 minibatches and hidden 64) is recorded once on the
CPU and committed:

    python tests/test_torch_validation.py --record \
        gym_fishing_tpu_torch/validation/jax_curve_fishing_v1.json

runs seeds 0 and 1 one after the other (about a quarter of an hour each on 8
CPU cores) in float32, writing the file after each seed.
``python -m gym_fishing_tpu_torch.validation.fused_training --against-jax``
reads it. The tests check the committed file's schema and flags, and run the
recorder at 64 envs x 16 steps x 30 iterations of 1 epoch x 1 minibatch (one
checkpoint), and ``--against-jax`` on what it wrote.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gym_fishing_tpu_torch.validation import fused_training  # noqa: E402
from gym_fishing_tpu_torch.validation.fused_training import (  # noqa: E402
    JAX_CURVE,
    checkpoints,
    load_jax_curve,
)

RECORDED_FLAGS = {"env": "fishing-v1", "sigma": 0.05, "num_envs": 4096, "num_steps": 128,
                  "iterations": 300, "epochs": 4, "num_minibatches": 8, "hidden": 64,
                  "form": "plain"}


def record(out, seeds=(0, 1), num_envs=4096, num_steps=128, iterations=300, **cfg_kw):
    """Train JAX's plain PPO form at each seed and write the curves to `out`
    (after every seed, so a cut run keeps what it finished). `cfg_kw` sets
    PPOConfig's epochs, num_minibatches or hidden."""
    import jax

    import gym_fishing_tpu as gft
    from gym_fishing_tpu.agents import ppo

    env, params = gft.make("fishing-v1", sigma=0.05)
    cfg = ppo.PPOConfig(num_envs=num_envs, num_steps=num_steps, **cfg_kw)
    doc = {
        "flags": {"env": "fishing-v1", "sigma": 0.05, "num_envs": num_envs,
                  "num_steps": num_steps, "iterations": iterations, "epochs": cfg.epochs,
                  "num_minibatches": cfg.num_minibatches, "hidden": cfg.hidden,
                  "form": "plain"},
        "jax_version": jax.__version__,
        "x64": bool(jax.config.jax_enable_x64),
        "backend": jax.default_backend(),
        "checkpoint_every": 30,
        "checkpoint_window": 10,
        "seeds": {},
    }
    for seed in seeds:
        t0 = time.perf_counter()
        _, history = ppo.train(env, cfg, seed=seed, iterations=iterations, env_params=params)
        rets = np.asarray([h["episode_return"] for h in history], np.float64)
        rets = np.where(np.isfinite(rets), rets, np.nan)
        doc["seeds"][str(seed)] = {
            "episode_return": [None if np.isnan(r) else float(r) for r in rets],
            "checkpoints": checkpoints(rets),
            "wall_s": time.perf_counter() - t0,
        }
        with open(out, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"seed {seed}: checkpoints {doc['seeds'][str(seed)]['checkpoints']}", flush=True)
    return doc


def test_committed_curve_schema():
    doc = load_jax_curve(JAX_CURVE)
    assert doc["flags"] == RECORDED_FLAGS
    assert doc["jax_version"] and doc["x64"] is False
    assert sorted(doc["seeds"]) == ["0", "1"]
    for run in doc["seeds"].values():
        rets = np.asarray([np.nan if r is None else r for r in run["episode_return"]])
        assert rets.shape == (300,)
        assert np.isfinite(rets[-100:]).all()
        assert run["checkpoints"] == checkpoints(rets)
        assert len(run["checkpoints"]) == 10
        # the plain form learns: it ends well above where it starts
        assert run["checkpoints"][-1] > run["checkpoints"][0] + 1.0


@pytest.fixture(scope="module")
def small_curve(tmp_path_factory):
    out = tmp_path_factory.mktemp("curve") / "curve.json"
    return out, record(out, seeds=(0, 1), num_envs=64, num_steps=16, iterations=30, epochs=1,
                       num_minibatches=1)


def test_recorder_small(small_curve):
    out, doc = small_curve
    on_disk = load_jax_curve(out)
    assert on_disk == json.loads(json.dumps(doc))
    assert on_disk["flags"] == dict(RECORDED_FLAGS, num_envs=64, num_steps=16, iterations=30,
                                    epochs=1, num_minibatches=1)
    for seed in ("0", "1"):
        rets = on_disk["seeds"][seed]["episode_return"]
        assert len(rets) == 30 and all(r is None or np.isfinite(r) for r in rets)
        assert len(on_disk["seeds"][seed]["checkpoints"]) == 1
    assert on_disk["seeds"]["0"]["episode_return"] != on_disk["seeds"]["1"]["episode_return"]


def test_against_jax_compares_each_form_with_the_curve(small_curve, capsys):
    """The comparison's arithmetic on the CPU at the small curve's sizes; the
    tolerance is opened wide because 64 envs make a noisy curve, and the
    card's run (chip_smoke.py phase 35) holds the bar of 0.25."""
    out, doc = small_curve
    rc = fused_training.main(["--against-jax", str(out), "--fused-adam", "--agreement",
                              "--device", "cpu", "--agreement-tol", "100"])
    line = json.loads(capsys.readouterr().out.splitlines()[0])
    aj = line["against_jax"]
    assert rc == 0 and line["pass"] and aj["ok"] and line["iterations"] == 30
    jax0 = doc["seeds"]["0"]["checkpoints"]
    assert aj["jax_seed0"] == [round(v, 4) for v in jax0]
    for form in ("fused", "plain"):
        assert aj[f"{form}_gap_max"] == pytest.approx(abs(aj[form][0] - jax0[0]), abs=2e-4)
    assert aj["jax_seed_gap_max"] == pytest.approx(
        abs(jax0[0] - doc["seeds"]["1"]["checkpoints"][0]), abs=2e-4)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="record JAX's plain PPO curve on the CPU")
    ap.add_argument("--record", required=True, metavar="OUT")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--num-steps", type=int, default=128)
    ap.add_argument("--iterations", type=int, default=300)
    args = ap.parse_args()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    record(args.record, tuple(args.seeds), args.num_envs, args.num_steps, args.iterations)
