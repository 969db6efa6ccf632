"""The readers of the program's spans (`spans.py` and the layer metrics
that use it) on synthetic traces, and on a real CPU trace of the PPO step:
K3's stages split by correlation id, host self time less the spans inside,
idle gaps put down to the innermost program span, and None where the spans
are missing."""

import json
from pathlib import Path

import pytest

import devtrace
import run as harness
import spans

BENCH = Path(__file__).resolve().parent.parent
READERS = ("update.stage1_ms", "update.dw2c_ms", "update.reduce_ms", "update.optimizer_ms",
           "train.glue_host_ms", "train.glue_idle_ms", "k1.prep_host_ms", "k1.prep_idle_ms")


def _read(name, trace):
    module = harness.load_module(BENCH / "layer_metrics" / f"{name}.py", f"t_{name}")
    return module.read({"trace": trace})


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _cpu_op(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _launch(corr, ts, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "tid": tid, "args": {"correlation": corr}}


def _kernel(name, corr, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "tid": 7,
            "args": {"correlation": corr}}


def _ppo_trace(units=2):
    """`units` iterations of 1000 us: a rollout whose prep (100 us, an aten
    op inside) leaves the card idle, K4 launched inside `k4` (with a
    `wide_prep`), one minibatch whose k3 launches one kernel of each stage
    (a gap of 10 us between stage 1 and dW2c), and the update's metrics (50
    us, a nested program span of 10 us)."""
    ev = []
    for u in range(units):
        t0, c = 1000.0 * u, 100 * u
        ev += [_span("bench/unit", t0, 1000), _span("train_step", t0, 1000),
               _span("train_step/rollout", t0, 300),
               _span("train_step/rollout/prep", t0, 100), _cpu_op("aten::copy_", t0 + 10, 80),
               _span("train_step/rollout/k4", t0 + 100, 200),
               _launch(c + 1, t0 + 110), _kernel("void wide_prep<256>(float const*)", c + 1,
                                                 t0 + 120, 10),
               _launch(c + 2, t0 + 150), _kernel("void policy_rollout_wide<256, true>(P)",
                                                 c + 2, t0 + 130, 170),
               _span("train_step/update", t0 + 300, 650),
               _span("train_step/update/minibatch", t0 + 300, 600),
               _span("train_step/update/adv_stats", t0 + 300, 20),
               _span("train_step/update/k3", t0 + 320, 580)]
        stages = ("void ppo_grad_wide<512, true, false>(GradParams, float const*)",
                  "void dw2c_split_bf16<128>(GradParams, int)",
                  "reduce_rows(float const*, int, int, float*)",
                  "clip_norm_parts(GradParams, float const*, float*)",
                  "clip_adam_apply(GradParams, AdamParams, float const*)")
        starts, durs = (300, 710, 780, 840, 850), (400, 70, 60, 10, 40)
        for i, (name, s, d) in enumerate(zip(stages, starts, durs)):
            ev += [_launch(c + 10 + i, t0 + 330 + i), _kernel(name, c + 10 + i, t0 + s, d)]
        ev += [_span("train_step/update/metrics", t0 + 900, 50),
               _span("train_step/update/inner", t0 + 920, 10),
               _span("train_step/metrics", t0 + 950, 50)]
    # a kernel of a stage launched outside every k3 span is not the update's
    ev += [_launch(999, 500.0, tid=2), _kernel("reduce_rows(float const*)", 999, 400, 1)]
    return devtrace.Trace({"traceEvents": ev})


def test_kernel_names_lose_return_type_templates_and_parameters():
    name = lambda n: spans.kernel_name({"name": n})  # noqa: E731
    assert name("void ppo_grad_wide<512, true, false>(GradParams, float const*)") == \
        "ppo_grad_wide"
    assert name("reduce_rows(float const*, int, int, float*)") == "reduce_rows"
    assert name("void ns::clip_adam_apply(GradParams)") == "clip_adam_apply"
    assert name("Memset (Device)") == "Memset"


def test_the_update_stages_split_by_correlation_id():
    trace = _ppo_trace()
    assert _read("update.stage1_ms", trace) == pytest.approx(0.4)   # not K4's wide_prep
    assert _read("update.dw2c_ms", trace) == pytest.approx(0.07)
    assert _read("update.reduce_ms", trace) == pytest.approx(0.06)  # not the one outside
    assert _read("update.optimizer_ms", trace) == pytest.approx(0.05)


def test_glue_host_time_is_self_time_less_the_spans_inside():
    # prep 100 (its aten op is no span) + adv_stats 20 + metrics 50 - 10 + step metrics 50
    assert _read("train.glue_host_ms", _ppo_trace()) == pytest.approx(0.21)


def test_idle_gaps_go_to_the_innermost_program_span():
    # the card idles 0-120 (mid 60: prep's aten op is open, but it is no span, so
    # prep), 700-710 (k3), 890-1120 (mid 1005: the next iteration's prep) and
    # 1890-2000 (mid 1945: the update's metrics, its nested span closed by then)
    trace = _ppo_trace()
    assert _read("train.glue_idle_ms", trace) == pytest.approx((120 + 230 + 110) / 2 / 1e3)
    assert spans.idle_us_under(trace, ("train_step/update/k3",)) == pytest.approx(2 * 10)
    # a gap under a program span nested in a glue span is the nested span's
    nested = devtrace.Trace({"traceEvents": [
        _span("bench/unit", 0, 100), _span("train_step/metrics", 0, 100),
        _span("train_step/metrics/inner", 40, 20), _launch(1, 1), _launch(2, 2),
        _kernel("a(int)", 1, 0, 40), _kernel("b(int)", 2, 60, 40)]})
    assert _read("train.glue_idle_ms", nested) == 0.0


def test_k1_prep_host_and_idle():
    ev = []
    for u in range(4):
        t0 = 100.0 * u
        ev += [_span("bench/unit", t0, 100), _span("bench/k1", t0, 90),
               _span("rollout_kernel/rollout", t0, 40), _span("rollout_kernel/prep", t0, 30),
               _span("rollout_kernel/launch", t0 + 30, 10), _launch(u, t0 + 32),
               _kernel("rollout_kernel(RolloutParams, float const*)", u, t0 + 35, 60)]
    trace = devtrace.Trace({"traceEvents": ev})
    assert _read("k1.prep_host_ms", trace) == pytest.approx(0.03)
    # idle 0-35 of the first call only (then the previous call's kernel runs to t0 - 5):
    # mid 17.5, under prep; then 95-135 (mid 115: prep of the next call) three times, and
    # the last call's 395-400 under bench/k1, which is the harness's
    assert _read("k1.prep_idle_ms", trace) == pytest.approx((35 + 3 * 40) / 4 / 1e3)


def test_none_where_the_spans_are_missing():
    """A trace of a program without the spans (the parent's), and no trace."""
    ev = [_span("bench/unit", 0, 100), _span("train_step/update", 0, 90),
          _span("bench/k1", 0, 90), _launch(1, 5), _kernel("reduce_rows(float*)", 1, 10, 20)]
    trace = devtrace.Trace({"traceEvents": ev})
    for name in READERS:
        assert _read(name, trace) is None, name
        assert _read(name, None) is None, name


def test_none_for_device_metrics_where_no_device_operation_ran():
    """A CPU trace has the spans but no kernels: the stage and idle metrics
    say nothing, the host ones read."""
    trace = devtrace.Trace({"traceEvents": [
        _span("bench/unit", 0, 100), _span("train_step", 0, 100),
        _span("train_step/update/k3", 10, 50), _span("train_step/metrics", 60, 40)]})
    assert _read("update.stage1_ms", trace) is None
    assert _read("train.glue_idle_ms", trace) is None
    assert _read("train.glue_host_ms", trace) == pytest.approx(0.04)


def test_a_cpu_trace_of_the_ppo_step_reads_the_glue(tmp_path):
    """The readers find the program's own spans in a real trace: the glue's
    host time is there on the CPU, the device metrics are not."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gym_fishing_tpu_torch.agents import ppo
    from gym_fishing_tpu_torch.batch import batched_reset
    from gym_fishing_tpu_torch.registry import make

    env, params = make("fishing-v1", device="cpu")
    cfg = ppo.PPOConfig(num_envs=128, num_steps=8, hidden=32, fused_update=True,
                        fused_rollout=True, fused_adam=True)
    ts = ppo.make_train_state(env, cfg, torch.Generator().manual_seed(0), device="cpu")
    bstate, gen = batched_reset(env, params, cfg.num_envs, "cpu"), torch.Generator()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with torch.profiler.record_function("bench/unit"):
                ts, bstate, _ = ppo.train_step(env, params, cfg, ts, bstate, gen)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = devtrace.Trace(json.loads(path.read_text()))
    assert trace.n_units == 2
    assert _read("train.glue_host_ms", trace) > 0
    assert all(_read(n, trace) is None for n in READERS if n != "train.glue_host_ms")
