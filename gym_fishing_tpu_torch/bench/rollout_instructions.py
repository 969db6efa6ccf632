"""How many instructions the stepping kernel (K1) executes per env and step
on fishing-v1, the time the schedulers alone need for them, and what fixing the
kernel's runtime switches at compile time would gain.

    python gym_fishing_tpu_torch/bench/rollout_instructions.py [--sass-out FILE]

A diagnostic of one compilation, not a bound of the function: the count
holds whatever the compiler emitted (branches, convergence barriers,
constant loads, the IEEE division's and the full-precision logf and
sincosf sequences); chip_smoke.py bounds K1 by the operations its algorithm
needs. Where no kernel profiler is at hand this counts from the machine
code: it
builds a copy of ``csrc/rollout_kernel.cu`` (into the gitignored ``_build/``)
with fishing-v1's model, policy, scheme, noise form and obs-noise switch
fixed as compile-time constants, disassembles it with ``cuobjdump -sass``,
and takes the step loop: the instructions from the target of the widest
backward branch of the kernel to that branch, which is one Philox block and
four steps. Of that span it counts the fast path: a forward branch is
followed when the block it jumps over is a slow path, that is a leaf block
(no nested convergence region) that calls a subroutine or touches local
memory, which is how the generated code handles the huge or denormal
arguments of sincosf, sqrtf and the division that these inputs never
produce; every other conditional branch falls through. The schedulers need

    instructions per step x B x T / 32 / (SMs x 4 schedulers x SM clock)

and the script times the shipped kernel and the copy in turns (shipped,
copy, copy, shipped) at B = 2^21, T = 512 with CUDA events, and holds the
copy's results against the shipped kernel's. Prints one JSON line; needs a
CUDA device, nvcc and cuobjdump.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent.parent
B, T, REPS = 1 << 21, 512, 5
STEPS_PER_LOOP = 4   # one Philox block feeds four steps
SCHEDULERS = 4       # warp schedulers per SM, one instruction each per clock

# fishing-v1 under the escapement policy: every runtime switch of the kernel
_FIXED = [(r"\bp\.policy\b", "ESCAPEMENT"), (r"\bp\.scheme\b", "CONTINUOUS"),
          (r"\bp\.noise_form\b", "ADDITIVE"), (r"\bp\.obs_noise\b", "0"),
          (r"\bp\.has_noise\b", "0"),
          (r"const int model = [^;]*;", "const int model = LOGISTIC;")]


def specialise(source: str) -> str:
    """`source` with fishing-v1's switches as constants; raises if one is
    not found."""
    for pattern, constant in _FIXED:
        source, n = re.subn(pattern, constant, source)
        if n == 0:
            raise RuntimeError(f"rollout_kernel.cu has no {pattern!r} to fix")
    return source


def step_loop(sass: str, kernel: str = "rollout_kernel"):
    """The instructions of the widest backward-branch loop of `kernel` in a
    ``cuobjdump -sass`` listing: [(address, text), ...]."""
    section, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line and "philox" not in line
            continue
        m = re.search(r"/\*([0-9a-f]{4,6})\*/\s+(.+?);", line)
        if inside and m:
            section.append((int(m.group(1), 16), m.group(2).strip()))
    loops = []
    for addr, text in section:
        m = re.search(r"\bBRA\b.*\b0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    if not loops:
        raise RuntimeError(f"no backward branch found in {kernel}")
    # the step loop is the widest one; the narrower ones (an inner loop of a
    # slow path, the loop's own tail) lie inside or after it
    first, last = max(loops, key=lambda span: span[1] - span[0])
    return [(a, t) for a, t in section if first <= a <= last]


def fast_path(loop):
    """The instructions of `loop` that run when no slow path is taken (see
    the module doc): a sub-list of `loop`."""
    index = {a: i for i, (a, _) in enumerate(loop)}
    slow = re.compile(r"\b(CALL|LDL|STL)\b")
    taken, i = [], 0
    while i < len(loop):
        addr, text = loop[i]
        taken.append(loop[i])
        m = re.search(r"\bBRA\b.*\b0x([0-9a-f]+)", text)
        target = int(m.group(1), 16) if m else None
        if target is not None and target > addr and target in index:
            skipped = [t for _, t in loop[i + 1:index[target]]]
            leaf_slow = (any(slow.search(t) for t in skipped)
                         and not any(opcode(t) == "BSSY" for t in skipped))
            if not text.startswith("@") or leaf_slow:
                i = index[target]
                continue
        i += 1
    return taken


def opcode(text: str) -> str:
    words = [w for w in text.split() if not w.startswith("@")]
    return words[0].split(".")[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sass-out", default=None, help="write the step loop's listing here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("rollout_instructions: needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import gym_fishing_tpu_torch as gtt
    from gym_fishing_tpu_torch.agents.policies import escapement
    from gym_fishing_tpu_torch.kernels import _build
    from gym_fishing_tpu_torch.kernels import rollout_kernel as rk

    shipped_csrc = _build.CSRC
    fixed_csrc = _build.BUILD_DIR / "fixed_csrc"
    shutil.rmtree(fixed_csrc, ignore_errors=True)
    _build.BUILD_DIR.mkdir(exist_ok=True)
    shutil.copytree(shipped_csrc, fixed_csrc)
    path = fixed_csrc / "rollout_kernel.cu"
    path.write_text(specialise(path.read_text()))

    def use(csrc):
        """Point the wrapper at the kernel built from `csrc`."""
        _build.CSRC = csrc
        _build._LIBS.clear()
        rk.library.cache_clear()
        return rk.library()

    dev = torch.device("cuda", 0)
    env, params = gtt.make("fishing-v1", sigma=0.05, device="cpu")  # K1 reads them on the host
    x_star = float(escapement(env, params).x_star)
    stock = torch.full((B,), float(params.init_state), dtype=torch.float32, device=dev)
    t0 = torch.zeros(B, dtype=torch.int32, device=dev)
    run = lambda: rk.rollout(stock, t0, params, "escapement", x_star, T, seed=2026)  # noqa: E731

    ms, results = {"shipped": [], "copy": []}, {}
    for which in ("shipped", "copy", "copy", "shipped"):
        use(shipped_csrc if which == "shipped" else fixed_csrc)
        run()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            out = run()
        end.record()
        torch.cuda.synchronize()
        ms[which].append(start.elapsed_time(end) / REPS)
        results[which] = out
    for name in ("stock", "reward", "ep_ret_sum"):
        err = float((getattr(results["copy"], name)
                     - getattr(results["shipped"], name)).abs().max())
        if not err <= 1e-5:
            raise SystemExit(f"rollout_instructions: the copy's {name} differs by {err:.3g}")
    if not torch.equal(results["copy"].ep_count, results["shipped"].ep_count):
        raise SystemExit("rollout_instructions: the copy's episode counts differ")

    _build.CSRC = fixed_csrc
    so = _build.library_path("rollout_kernel")
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    loop = step_loop(sass)
    if args.sass_out:
        Path(args.sass_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.sass_out).write_text("\n".join(f"{a:05x}  {t}" for a, t in loop) + "\n")
    fast = fast_path(loop)
    mix = collections.Counter(opcode(t) for _, t in fast)
    per_step = len(fast) / STEPS_PER_LOOP
    smi = lambda q: subprocess.run(  # noqa: E731
        ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.strip().splitlines()[0]
    clock_mhz = float(smi("clocks.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sched_ms = per_step * B * T / 32 / (sms * SCHEDULERS * clock_mhz * 1e6) * 1e3
    shipped = min(ms["shipped"])
    print(json.dumps({
        "card": smi("name,power.limit"), "sm_clock_mhz": clock_mhz, "sms": sms, "B": B, "T": T,
        "loop_instructions": len(loop), "fast_path_instructions": len(fast),
        "instructions_per_step": per_step,
        "mix": dict(mix.most_common()), "scheduler_ms_of_the_copy": sched_ms,
        "shipped_ms": ms["shipped"], "copy_ms": ms["copy"],
        "copy_over_shipped": min(ms["copy"]) / shipped,
        "scheduler_share_of_the_copy": sched_ms / min(ms["copy"]),
    }))


if __name__ == "__main__":
    main()
