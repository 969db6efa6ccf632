"""The port's spans (utils/trace.py::span) and the update's stage table.

- With no profiler recording, `span` hands back one shared null context and
  builds no `record_function`; under the profiler it is a
  ``user_annotation`` event of the trace, under its name.
- A profiled PPO step on the CPU carries the span tree the benchmark's
  readers match by name: one ``train_step``, its rollout, update and
  metrics, a ``train_step/update/minibatch`` per minibatch with its
  advantage statistics and kernel call inside, every child inside its
  parent on one thread; and the profiler changes no bit of the step.
- K1's wrapper marks itself on the CPU path too.
- `KERNEL_STAGES` names every ``__global__`` of the update kernel's sources
  once.

The ``cuda`` test checks on the card that the kernels fall inside the spans
that launch them (by correlation id):

    python -m pytest --noconftest -q -m cuda tests/test_torch_trace.py
"""

import json
import re
from collections import Counter
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gym_fishing_tpu_torch as gtt
from gym_fishing_tpu_torch.agents import ppo
from gym_fishing_tpu_torch.batch import batched_reset
from gym_fishing_tpu_torch.kernels import ppo_update_kernel as uk
from gym_fishing_tpu_torch.kernels import rollout_kernel as rk
from gym_fishing_tpu_torch.utils import trace

torch.set_num_threads(1)

HELPER = Path(trace.__file__).resolve()
PACKAGE = HELPER.parent.parent

FORMS = {
    "full+adam": dict(fused_update=True, fused_rollout=True, fused_adam=True),
    "full": dict(fused_update=True, fused_rollout=True),
    "update+adam": dict(fused_update=True, fused_adam=True),
}

# each span of the step -> the span it must lie inside
PARENT = {
    "train_step/rollout": "train_step",
    "train_step/update": "train_step",
    "train_step/metrics": "train_step",
    "train_step/rollout/prep": "train_step/rollout",
    "train_step/rollout/k4": "train_step/rollout",
    "train_step/rollout/state": "train_step/rollout",
    "train_step/update/merge": "train_step/update",
    "train_step/update/minibatch": "train_step/update",
    "train_step/update/writeback": "train_step/update",
    "train_step/update/metrics": "train_step/update",
    "train_step/update/adv_stats": "train_step/update/minibatch",
    "train_step/update/k3": "train_step/update/minibatch",
    "train_step/update/k2": "train_step/update/minibatch",
    "train_step/update/adam": "train_step/update/minibatch",
}


def _events(prof, tmp_path, cat="user_annotation"):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and (cat is None or e.get("cat") == cat)]


def _inside(child, parent, slack=1e-3):
    return (parent["ts"] - slack <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"] + slack)


def _setup(form, device="cpu", num_envs=128, num_steps=8, hidden=32, seed=0,
           compute_dtype="float32"):
    env, params = gtt.make("fishing-v1", device="cpu")
    cfg = ppo.PPOConfig(num_envs=num_envs, num_steps=num_steps, hidden=hidden,
                        compute_dtype=compute_dtype, **FORMS[form])
    ts = ppo.make_train_state(env, cfg, torch.Generator().manual_seed(seed), device=device)
    bstate = batched_reset(env, params, cfg.num_envs, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return env, params, cfg, ts, bstate, gen


# ------------------------------------------------------------------ span


def test_span_is_the_shared_null_context_when_no_profiler_records(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    first, second = trace.span("a"), trace.span("b")
    assert first is second is trace._OFF
    with first:
        with second:
            pass


def test_span_checks_the_gate_at_every_call():
    assert trace.span("x") is trace._OFF
    with profile(activities=[ProfilerActivity.CPU]):
        inside = trace.span("x")
        assert inside is not trace._OFF
        with inside:
            pass
    assert trace.span("x") is trace._OFF


def test_span_is_a_user_annotation_under_the_profiler(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer/inner"):
            torch.ones(8).sum()
    found = [e for e in _events(prof, tmp_path) if e["name"] == "outer/inner"]
    assert len(found) == 1 and found[0]["dur"] > 0


def test_no_record_function_outside_the_span_helper():
    """`span` is the port's only way to mark a span."""
    users = sorted(str(p.relative_to(PACKAGE)) for p in PACKAGE.rglob("*.py")
                   if "record_function" in p.read_text() and p != HELPER)
    assert users == []


# ------------------------------------------------------------------ the PPO step


@pytest.mark.parametrize("form", sorted(FORMS))
def test_a_profiled_train_step_has_the_span_tree(form, tmp_path):
    env, params, cfg, ts, bstate, gen = _setup(form)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ppo.train_step(env, params, cfg, ts, bstate, gen)
    spans = [e for e in _events(prof, tmp_path) if e["name"].startswith("train_step")]
    count = Counter(e["name"] for e in spans)
    full, adam = cfg.fused_rollout, cfg.fused_adam
    n_mb = cfg.epochs * cfg.num_minibatches
    assert count["train_step"] == 1
    assert count["train_step/rollout"] == count["train_step/update"] == 1
    assert count["train_step/metrics"] == 1
    for child in ("prep", "k4", "state"):
        assert count[f"train_step/rollout/{child}"] == (1 if full else 0)
    assert count["train_step/update/minibatch"] == n_mb
    assert count["train_step/update/adv_stats"] == n_mb
    assert count["train_step/update/k3"] == (n_mb if adam else 0)
    assert count["train_step/update/k2"] == count["train_step/update/adam"] == (
        0 if adam else n_mb)
    assert count["train_step/update/merge"] == count["train_step/update/metrics"] == 1
    assert count["train_step/update/writeback"] == (1 if adam else 0)
    assert set(count) <= set(PARENT) | {"train_step"}
    assert len({e["tid"] for e in spans}) == 1
    for child in spans:
        if child["name"] == "train_step":
            continue
        parents = [p for p in spans if p["name"] == PARENT[child["name"]] and _inside(child, p)]
        assert len(parents) == 1, child
    # each minibatch holds its own statistics and kernel call, once
    kids = ("adv_stats", "k3") if adam else ("adv_stats", "k2", "adam")
    for mb in (e for e in spans if e["name"] == "train_step/update/minibatch"):
        inner = Counter(e["name"] for e in spans
                        if e is not mb and _inside(e, mb) and e["name"] != mb["name"])
        assert inner == Counter(f"train_step/update/{k}" for k in kids)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_the_profiler_changes_no_bit_of_the_step(form):
    out = []
    for traced in (False, True):
        env, params, cfg, ts, bstate, gen = _setup(form, seed=3)
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                ts, bstate, metrics = ppo.train_step(env, params, cfg, ts, bstate, gen)
        else:
            ts, bstate, metrics = ppo.train_step(env, params, cfg, ts, bstate, gen)
        out.append((ts, bstate, metrics))
    (ts0, bs0, m0), (ts1, bs1, m1) = out
    for a, b in ((ts0.params(), ts1.params()), (ts0.m, ts1.m), (ts0.v, ts1.v), (m0, m1)):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a), form
    assert ts0.count == ts1.count and ts0.step == ts1.step
    for a, b in ((bs0.env.stock, bs1.env.stock), (bs0.env.t, bs1.env.t),
                 (bs0.episode_return, bs1.episode_return)):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ K1, K3


def test_k1_marks_its_cpu_path(tmp_path):
    _, params = gtt.make("fishing-v1", device="cpu", sigma=0.1)
    stock, t = torch.full((64,), 0.75), torch.zeros(64, dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rk.rollout(stock, t, params, "escapement", 0.5, 4, seed=1)
    names = Counter(e["name"] for e in _events(prof, tmp_path))
    assert names["rollout_kernel/rollout"] == 1
    # the twin neither prepares nor launches a kernel
    assert names["rollout_kernel/prep"] == names["rollout_kernel/launch"] == 0


_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


def test_kernel_stages_name_every_kernel_of_the_update_sources_once():
    found = []
    for name in ("ppo_update_kernel.cu", "wide_mlp.cuh"):
        found += _GLOBAL.findall((PACKAGE / "csrc" / name).read_text())
    listed = [k for kernels in uk.KERNEL_STAGES.values() for k in kernels]
    assert sorted(uk.KERNEL_STAGES) == ["dw2c", "optimizer", "reduce", "stage1"]
    assert len(listed) == len(set(listed))
    assert sorted(found) == sorted(listed)


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _kernel_name(event):
    head = event["name"].split("(", 1)[0].split("<", 1)[0].split()
    return head[-1] if head else ""


def _launched_inside(events, span_names):
    """Per device kernel: the name of the span (among `span_names`) whose
    interval holds the launch that queued it, or None."""
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] in span_names]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    out = []
    for k in (e for e in events if e.get("cat") == "kernel"):
        host = launch.get(k["args"].get("correlation"))
        held = [s["name"] for s in spans if host is not None and s["tid"] == host["tid"]
                and s["ts"] <= host["ts"] <= s["ts"] + s["dur"]]
        out.append((_kernel_name(k), held[0] if held else None))
    return out


@pytest.mark.cuda
def test_kernels_fall_inside_the_spans_that_launch_them(cuda, tmp_path):
    with torch.autograd.profiler.emit_nvtx():
        assert trace.span("nvtx") is not trace._OFF
    # K1 inside its wrapper's launch span
    _, params = gtt.make("fishing-v1", device="cpu", sigma=0.05)
    stock = torch.full((1 << 16,), 0.75, device=cuda)
    t = torch.zeros(1 << 16, dtype=torch.int32, device=cuda)
    rk.rollout(stock, t, params, "escapement", 0.5, 64, seed=1)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        rk.rollout(stock, t, params, "escapement", 0.5, 64, seed=1)
        torch.cuda.synchronize()
    got = _launched_inside(_events(prof, tmp_path, None), {"rollout_kernel/launch"})
    assert ("rollout_kernel", "rollout_kernel/launch") in got
    # K3's kernels inside the update's k3 spans (the wide bf16 path)
    env, params, cfg, ts, bstate, gen = _setup("full+adam", cuda, num_envs=2048, num_steps=16,
                                               hidden=256, compute_dtype="bfloat16")
    ts, bstate, _ = ppo.train_step(env, params, cfg, ts, bstate, gen)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        ppo.train_step(env, params, cfg, ts, bstate, gen)
        torch.cuda.synchronize()
    got = _launched_inside(_events(prof, tmp_path, None),
                           {"train_step/update/k3", "train_step/rollout/k4"})
    stage_of = {k: st for st, ks in uk.KERNEL_STAGES.items() for k in ks}
    staged = [(name, span) for name, span in got if name in stage_of]
    for name, span in staged:
        assert span == "train_step/update/k3" or (name == "wide_prep"
                                                 and span == "train_step/rollout/k4"), name
    in_k3 = {stage_of[name] for name, span in staged if span == "train_step/update/k3"}
    assert in_k3 == set(uk.KERNEL_STAGES)
