"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's entry in BENCHMARK.json names its
configuration and traffic mix; the configuration file names its driver
(`drivers/<driver>.py`), and every metric is read by a file of its own
(`end_to_end/<name>.py`, `layer_metrics/<name>.py`), so a cell, a mix or a
metric is added as files and entries, with no file edited.

The run loads and warms up the program, measures for `--seconds`, frees the
program's state, runs the plain reference over what the check compares,
and prints, as the last lines of standard error, each number compared
beside its limit, and as the last line of standard output one JSON object.
With `--trace 0` its metrics are the cell's end-to-end metrics; with
`--trace 1` a stretch of the window is traced and they are its per-layer
metrics. Without a CUDA card, or with fewer cards than the cell asks for,
it fails and prints no result; so it does if JAX or the JAX package has
been loaded.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gym_fishing_tpu")


def load_module(path: Path, name: str):
    """Import a file of the benchmark by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str, bench_file: Path = ROOT / "BENCHMARK.json"):
    """(the BENCHMARK.json document, the cell's entry, its configuration,
    its traffic mix, its driver module)."""
    doc = json.loads(bench_file.read_text())
    cells = {w["name"]: w for w in doc["workloads"]}
    if name not in cells:
        raise SystemExit(f"no such workload: {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    files = {c["name"]: c["file"] for c in doc["configs"]}
    config = json.loads((bench_file.parent / files[cell["config"]]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    driver = load_module(BENCH / "drivers" / f"{config['driver']}.py", config["driver"])
    return doc, cell, config, traffic, driver


def metrics_of(doc, cell_name: str, kind: str):
    """The metrics of `kind` ("end_to_end" or "per_layer") that the cell
    reports: those that list it, or that list no cells."""
    return [m for m in doc[kind] if cell_name in m.get("workloads", [cell_name])]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def execute(doc, cell, config, traffic, driver, seed: int, seconds: float, trace: bool,
            device, process_start: float):
    """Set up, measure, check; returns the result as a dict and the numbers
    compared as (name, value, limit)."""
    import torch

    import devtrace

    run = driver.prepare(config, traffic, seed, device)
    setup_s = time.perf_counter() - process_start
    tracer = devtrace.Tracer(trace, driver.TRACE_FIRST, driver.TRACE_COUNT)
    units = driver.measure(run, seconds, tracer)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    tr = tracer.finish()
    kept = driver.release(run)
    del run
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = driver.compare(config, seed, device, kept)
    del kept
    limits = config["limits"]
    checks = [(k, float(numbers[k]), float(limits[k])) for k in limits]
    correct = all(v <= lim for _, v, lim in checks) and set(numbers) >= set(limits)

    record = {"setup_s": setup_s, "units": units, "facts": driver.facts(config), "trace": tr,
              "traced": (driver.TRACE_FIRST, driver.TRACE_COUNT) if trace else (0, 0)}
    kind, folder = ("per_layer", "layer_metrics") if trace else ("end_to_end", "end_to_end")
    metrics = {}
    for m in metrics_of(doc, cell["name"], kind):
        value = load_module(BENCH / folder / f"{m['name']}.py", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak) if cuda else 0}
    result = {"correct": bool(correct), "attempted": len(units),
              "failed": int(sum(u[3] for u in units)), "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_us() / 1e6
        dev["window_s"] = tr.window_us / 1e6
        result["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # kernel caches at fixed places inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".cache" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".cache" / "torch_extensions"))
    sys.path[:0] = [str(BENCH), str(ROOT)]
    doc, cell, config, traffic, driver = load_cell(args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"error: {args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}; no result",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result, checks = execute(doc, cell, config, traffic, driver, args.seed, args.seconds,
                                bool(args.trace), "cuda", PROCESS_START)
    found = forbidden_modules()
    if found:
        print(f"error: loaded in this process: {', '.join(found)}; no result", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, value, limit in checks:
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
