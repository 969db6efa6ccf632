"""The port's multi-process entry points on the CPU: the rank launcher
(``shard.launch.spawn_ranks``), ``examples/multihost_train`` at one and two
processes, and ``bench.scaling.weak_scaling`` at 1 and 2 gloo ranks.

multihost_train at two processes (a ``file://`` coordinator, 32 envs each)
runs the global step of 64 envs, so rank 0 prints the episode return that
one process with 64 envs prints. weak_scaling is checked for what it
returns, not for its speed. The launcher fails, and stops every rank, when
a rank exits non-zero, outlives its timeout or leaves no result.
"""

import os
import re
import subprocess
import sys
import tempfile
import time

import pytest
import torch

from gym_fishing_tpu_torch.bench.scaling import weak_scaling
from gym_fishing_tpu_torch.examples import multihost_train
from gym_fishing_tpu_torch.shard.launch import spawn_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")

torch.set_num_threads(1)


def rank_echo(mesh, job):
    return {"rank": mesh.rank, "world": mesh.world, "job": job,
            "sum": float(mesh.all_reduce(torch.ones(1))[0])}


def rank_fails(mesh, job):
    if mesh.rank == job:
        raise SystemExit(3)
    return mesh.rank


def rank_hangs(mesh, job):
    time.sleep(60)


def rank_returns_nothing(mesh, job):
    os._exit(0)


@pytest.fixture
def spawn(monkeypatch, tmp_path):
    """spawn_ranks of a target in this file, with TMPDIR under tmp_path to
    see that the ranks' directory goes away."""
    monkeypatch.setenv("PYTHONPATH", TESTS)   # the children import this file by name
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))

    def run(target, job=7, **kw):
        try:
            return spawn_ranks(f"test_torch_multihost:{target}", 2, job, **kw)
        finally:
            assert os.listdir(tmp_path) == []
    return run


def test_spawn_ranks_returns_each_ranks_result(spawn):
    out = spawn("rank_echo")
    assert out == [{"rank": r, "world": 2, "job": 7, "sum": 2.0} for r in range(2)]


def test_spawn_ranks_fails_on_a_rank_that_exits_non_zero(spawn):
    with pytest.raises(RuntimeError, match="rank 1 of .* exited 3"):
        spawn("rank_fails", 1)


def test_spawn_ranks_fails_on_a_timeout_and_stops_the_ranks(spawn):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not finish in 3"):
        spawn("rank_hangs", timeout_s=3)
    assert time.monotonic() - t0 < 30


def test_spawn_ranks_fails_on_a_missing_result(spawn):
    with pytest.raises(RuntimeError, match="left no result"):
        spawn("rank_returns_nothing")


def test_multihost_train_one_process(capsys):
    hist = multihost_train.main(["--device", "cpu", "--num-envs-per-chip", "64",
                                 "--num-steps", "16", "--iterations", "2"])
    assert len(hist) == 2 and all(torch.isfinite(torch.tensor(h["loss"])) for h in hist)
    assert "iter 0: ep_ret=" in capsys.readouterr().out


def _ep_ret(text):
    return float(re.search(r"iter 0: ep_ret=([-0-9.]+) \((\d) ranks, 64 envs\)", text).group(1))


def test_multihost_train_two_processes_run_the_global_step(tmp_path, capsys):
    multihost_train.main(["--device", "cpu", "--num-envs-per-chip", "64", "--num-steps", "16",
                          "--iterations", "1"])
    one = _ep_ret(capsys.readouterr().out)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("MASTER_ADDR", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gym_fishing_tpu_torch.examples.multihost_train",
         "--coordinator", f"file://{tmp_path}/rendezvous", "--num-processes", "2",
         "--process-id", str(r), "--device", "cpu", "--num-envs-per-chip", "32",
         "--num-steps", "16", "--iterations", "1"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "(2 ranks, 64 envs)" in outs[0][0] and outs[1][0] == ""
    assert _ep_ret(outs[0][0]) == pytest.approx(one, abs=2e-5)


def test_weak_scaling_at_one_and_two_ranks():
    out = weak_scaling(envs_per_device=256, num_steps=8, iters=2, device_counts=[1, 2],
                       device="cpu")
    assert set(out["throughput"]) == {1, 2} and out["device"] == "cpu"
    assert all(v > 0 for v in out["throughput"].values())
    assert out["efficiency"][1] == 1.0 and out["efficiency"][2] > 0
    assert out["envs_per_device"] == 256


def test_weak_scaling_defaults_to_one_rank_on_the_cpu():
    out = weak_scaling(envs_per_device=128, num_steps=4, iters=1, device="cpu")
    assert list(out["throughput"]) == [1]


def test_weak_scaling_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        weak_scaling()
