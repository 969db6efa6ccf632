"""The cell `rppo-lstm256-fishing-v2.f32` through the harness's own run (its
look for a card skipped): the port's LSTM recurrent PPO against
`reference/rppo_lstm.py`, the TF32 control and the faults planted under
the timed path, on the CPU at a size it runs in seconds (64 envs x 32
steps; the widths and every other setting of the configuration kept), and
on the card, where there is one, at the cell's own size; the cell's
yardstick (`roofline_rppo.py`) and the readers of its spans.

Faults, each a context manager that patches the program's module in place
and restores it on exit:

- `no_reset`: the recurrent states carried across an episode start;
- `no_carry`: the states zeroed after every step;
- `half_batch`: each minibatch's second half of envs replaced by its first;
- `unchanged`: a train step whose weights, moments and counts are put back
  as they were after it.
"""

import contextlib
import time

import pytest

import faults
import run as harness

CELL = "rppo-lstm256-fishing-v2.f32"
SEED = 2 ** 31 + 4099
TINY = {"num_envs": 64, "num_steps": 32}
FAULTS = ("no_reset", "no_carry", "half_batch", "unchanged")


@contextlib.contextmanager
def plant(fault: str):
    import torch

    from gym_fishing_tpu_torch.agents import ppo_rnn

    if fault in ("no_reset", "no_carry"):
        def wrap(zero_done):
            def _zero_done(state, done, tally=None):
                if fault == "no_reset":
                    return state
                return zero_done(state, torch.ones_like(done), tally)
            return _zero_done
        name = "_zero_done"
    elif fault == "half_batch":
        def wrap(minibatch_envs):
            def _minibatch_envs(perm, i, mb_envs):
                envs = minibatch_envs(perm, i, mb_envs)
                half = envs[:max(1, mb_envs // 2)]
                return torch.cat([half, half])[:mb_envs]
            return _minibatch_envs
        name = "_minibatch_envs"
    elif fault == "unchanged":
        def wrap(step):
            def train_step(env, env_params, cfg, ts, bstate, h, *a, **kw):
                saved = [x.detach().clone() for x in (*ts.model.parameters(), *ts.m.values(),
                                                      *ts.v.values())]
                counts = ts.count, ts.step
                _, _, _, metrics = step(env, env_params, cfg, ts, bstate, h, *a, **kw)
                with torch.no_grad():
                    for x, s in zip((*ts.model.parameters(), *ts.m.values(), *ts.v.values()),
                                    saved):
                        x.copy_(s)
                ts.count, ts.step = counts
                return ts, bstate, h, metrics
            return train_step
        name = "train_step"
    else:
        raise ValueError(f"no such fault: {fault!r}")
    with faults._patched(ppo_rnn, name, wrap):
        yield


def _loaded(size=None):
    doc, cell, config, traffic, driver = harness.load_cell(CELL)
    if size:
        config["rppo"].update(size)
    return doc, cell, config, traffic, driver


def _run(loaded, seed=SEED, device="cpu", seconds=0.05):
    doc, cell, config, traffic, driver = loaded
    return harness.execute(doc, cell, config, traffic, driver, seed, seconds, False, device,
                           time.perf_counter())


def test_the_port_agrees_with_the_lstm_reference():
    result, checks = _run(_loaded(TINY))
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    numbers = {k: v for k, v, _ in checks}
    assert numbers["resets"] == 0 and numbers["off_path"] == 0
    assert set(result["metrics"]) >= {"setup_s", "train_env_steps_per_s"}


def test_the_control_in_tf32_is_not_correct():
    _, _, config, traffic, driver = _loaded(TINY)
    numbers = driver.control(config, traffic, SEED, "cpu")
    over = [k for k, lim in config["limits"].items() if numbers[k] > lim]
    assert over, numbers


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_under_the_timed_path_is_not_correct(fault):
    loaded = _loaded(TINY)
    with plant(fault):
        result, checks = _run(loaded)
    assert not result["correct"], checks


def test_the_tf32_rounder_keeps_ten_fraction_bits():
    import torch

    from reference import rppo_lstm
    rnd = rppo_lstm.tf32_rounder()
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -10),
                      1.0 + 2.0 ** -12, 3.0e-3])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -10), 1.0,
                         float(rnd(torch.tensor([3.0e-3]))[0])])
    assert torch.equal(rnd(x), want)
    assert torch.equal(rnd(rnd(x)), rnd(x))
    assert float((rnd(torch.tensor([3.0e-3])) - 3.0e-3).abs()) <= 3.0e-3 * 2.0 ** -11


def test_the_yardstick_counts_the_published_model():
    """0.57 M parameters, ~1.14 M forward FLOPs a sample, ~31 TFLOP an
    iteration; both halves bound by their operations at the float32 peak."""
    import roofline
    import roofline_rppo as rr
    _, _, config, _, driver = _loaded()
    f = driver.facts(config)
    assert rr.lstm_params(1, 256, (64, 64), 1) == 571_779
    assert rr.lstm_forward_flops(1, 256, (64, 64), 1) == 1_134_848
    assert f["flops_per_unit"] == pytest.approx(1_134_848 * 2 ** 21 * 13)
    assert f["peak_flops"] == roofline.PEAK["float32"] and f["work_per_unit"] == 2 ** 21
    assert f["rollout_least_ms"] == pytest.approx(1_134_848 * 2 ** 21 / 67e9)
    assert f["update_least_ms"] == pytest.approx(12 * 1_134_848 * 2 ** 21 / 67e9)
    assert rr.update_bound(16384, 128, 4, 4, 1, 256, (64, 64), 1)[1] == "operations"


def _event(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_the_span_readers_take_graph_launches_and_kernels():
    """Per iteration of 1000 us: an env span with one kernel launch, a
    replay span that launches a graph of two kernels, a backward span with
    one; each reader takes its own span's device time, and gives None
    without the span."""
    import devtrace
    from test_benchmark_spans import _read
    ev = []
    for u in range(2):
        t0, c = 1000.0 * u, 10 * u
        ev += [_event("user_annotation", "bench/unit", t0, 1000),
               _event("user_annotation", "train_step", t0, 1000),
               _event("user_annotation", "train_step/rollout/env", t0 + 10, 50),
               _event("cuda_runtime", "cudaLaunchKernel", t0 + 20, 1, c + 1),
               _event("kernel", "elementwise", t0 + 30, 5, c + 1, tid=7),
               _event("user_annotation", "train_step/update/replay", t0 + 100, 50),
               _event("cuda_runtime", "cudaGraphLaunch", t0 + 110, 5, c + 2),
               _event("kernel", "sgemm", t0 + 120, 100, c + 2, tid=7),
               _event("kernel", "sigmoid", t0 + 200, 40, c + 2, tid=7),
               _event("user_annotation", "train_step/update/backward", t0 + 300, 50),
               _event("cuda_runtime", "cudaGraphLaunch", t0 + 310, 5, c + 3),
               _event("kernel", "sgemm", t0 + 320, 300, c + 3, tid=7)]
    trace = devtrace.Trace({"traceEvents": ev})
    assert _read("rppo.env_ms", trace) == pytest.approx(0.005)
    assert _read("rppo.replay_ms", trace) == pytest.approx(0.120)
    assert _read("rppo.backward_ms", trace) == pytest.approx(0.300)
    bare = devtrace.Trace({"traceEvents": [e for e in ev if "update" not in e["name"]]})
    assert _read("rppo.replay_ms", bare) is None and _read("rppo.backward_ms", bare) is None


@pytest.mark.cuda
def test_on_the_card_the_port_is_correct(card):
    result, checks = _run(_loaded(), seed=3_200_000_011, device=card, seconds=1.0)
    assert result["correct"], checks


@pytest.mark.cuda
def test_on_the_card_the_control_is_not_correct_on_three_seeds(card):
    _, _, config, traffic, driver = _loaded()
    for seed in (3_100_000_007, 3_100_000_019, 3_100_000_031):
        numbers = driver.control(config, traffic, seed, card)
        assert any(numbers[k] > lim for k, lim in config["limits"].items()), (seed, numbers)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS)
def test_on_the_card_a_fault_is_not_correct(card, fault):
    with plant(fault):
        result, checks = _run(_loaded(), seed=3_200_000_023, device=card, seconds=0.5)
    assert not result["correct"], checks
