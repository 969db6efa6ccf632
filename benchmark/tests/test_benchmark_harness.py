"""The harness itself: what it imports, how it finds cells and metrics by
name, the names and units of BENCHMARK.json, and its refusal to run
without a card."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path


BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

_IMPORTS = r"""
import sys, time, importlib.util
from pathlib import Path
bench = Path(sys.argv[1]); sys.path[:0] = [str(bench), str(bench.parent)]
import torch
torch.set_num_threads(1)
import run as harness
for path in sorted(bench.rglob("*.py")):
    if "tests" in path.parts:
        continue
    harness.load_module(path, "m_" + str(path.relative_to(bench)).replace("/", "_")[:-3])
sizes = {"ppo-fishing-v1-h256.bf16": {"ppo": {"num_envs": 256, "num_steps": 16}},
         "sim-fishing-v1-escapement.batch2M": {"stepping": {"num_envs": 256, "num_steps": 16}}}
for name, over in sizes.items():
    doc, cell, config, traffic, driver = harness.load_cell(name)
    for k, v in over.items():
        config[k].update(v)
    harness.execute(doc, cell, config, traffic, driver, 11, 0.05, False, "cpu",
                    time.perf_counter())
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_module_of_jax_or_the_jax_package_is_loaded():
    """Every module of the harness, its drivers, metrics and reference, and
    a run of each cell on the CPU, load no module whose top-level name is
    jax, jaxlib, flax or gym_fishing_tpu (gym_fishing_tpu_torch is another
    name)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORTS, str(BENCH)], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(out.stdout.split())
    assert "gym_fishing_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "gym_fishing_tpu"}


def test_the_harness_finds_the_forbidden_names_whole():
    import run as harness
    assert "gym_fishing_tpu" in harness.FORBIDDEN
    sys.modules.setdefault("gym_fishing_tpu_torch_probe", None)
    try:
        assert "gym_fishing_tpu_torch_probe" not in harness.forbidden_modules()
    finally:
        del sys.modules["gym_fishing_tpu_torch_probe"]


_ADDED = r"""
import sys, time, json
from pathlib import Path
bench = Path(sys.argv[1]); sys.path[:0] = [str(bench), sys.argv[2]]
import run as harness
doc, cell, config, traffic, driver = harness.load_cell("sim-fishing-v1-escapement.added",
                                                       bench.parent / "BENCHMARK.json")
config["stepping"].update({"num_envs": 256, "num_steps": 16})
driver.TRACE_FIRST, driver.TRACE_COUNT = 1, 2
res, _ = harness.execute(doc, cell, config, traffic, driver, 5, 0.05, True, "cpu",
                            time.perf_counter())
print(json.dumps(res["metrics"]))
"""


def test_a_cell_and_a_metric_added_as_files_are_found_by_name(tmp_path):
    """A traffic mix, a cell and a per-layer metric added as new files and
    entries run, with no file of the benchmark edited."""
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (copy / "benchmark").rglob("*") if p.is_file()}
    doc = json.loads(json.dumps(DOC))
    (copy / "benchmark" / "traffic" / "eval-closed-loop-added.json").write_text(
        json.dumps({"loop": "closed", "clients": 1, "unit": "call", "initial_year": "reset"}))
    (copy / "benchmark" / "layer_metrics" / "sim.units_traced.py").write_text(
        "def read(record):\n"
        "    trace = record.get('trace')\n"
        "    return None if trace is None else float(trace.n_units)\n")
    doc["workloads"].append({"name": "sim-fishing-v1-escapement.added",
                             "config": "sim-fishing-v1-escapement",
                             "traffic": "eval-closed-loop-added", "chips": 1, "why": "added"})
    doc["per_layer"].append({"name": "sim.units_traced", "unit": "calls", "better": "higher",
                             "source": "device_trace", "layer": "device (H100)",
                             "moves": "sim_env_steps_per_s",
                             "workloads": ["sim-fishing-v1-escapement.added"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(doc))
    out = subprocess.run([sys.executable, "-c", _ADDED, str(copy / "benchmark"), str(ROOT)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert metrics["sim.units_traced"]["value"] == 2.0
    assert all(p.read_bytes() == b for p, b in before.items())


def test_names_units_and_keys_of_benchmark_json():
    names = ([c["name"] for c in DOC["configs"]] + [w["name"] for w in DOC["workloads"]]
             + [m["name"] for m in DOC["end_to_end"] + DOC["per_layer"]])
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for w in DOC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in DOC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    assert {m["name"] for m in DOC["end_to_end"]} >= {"setup_s"}
    assert all(0.01 <= m["bound"] <= 0.25 for m in DOC["end_to_end"])
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_every_metric_has_its_reader_and_every_cell_its_files():
    for m in DOC["end_to_end"]:
        assert (BENCH / "end_to_end" / f"{m['name']}.py").is_file()
    for m in DOC["per_layer"]:
        assert (BENCH / "layer_metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in {e["name"] for e in DOC["end_to_end"]}
    for w in DOC["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        config = json.loads((ROOT / next(c["file"] for c in DOC["configs"]
                                         if c["name"] == w["config"])).read_text())
        assert (BENCH / "drivers" / f"{config['driver']}.py").is_file()


def test_run_fails_without_a_card_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "sim-fishing-v1-escapement.batch2M", "--seed", "3000000000",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
