"""The stepping kernel (K1) alone on the card: its time, its executed
instructions, its errors, and its other configurations.

    python gym_fishing_tpu_torch/bench/rollout_instructions.py [--root DIR] [--reps N]
        [--sass-out FILE] [--errors] [--models]

With no mode it times one call of the wrapper on fishing-v1 under escapement
at B = 2^21, T = 512, noise from a seed: the median of `--reps` calls, each
between its own pair of CUDA events, after 5 warm-up calls that bring the
clocks up. `--root` names the checkout whose ``gym_fishing_tpu_torch`` is
imported (default: the one this file lies in), so two versions of the
kernel can be timed in turns on one card, a process each. Where the
checkout builds the kernel per configuration it also counts the
instructions per env and step of the shipped fishing-v1 library, the time
the schedulers alone need for them, and the registers, the CTAs an SM holds
and the waves at this B. Prints one JSON line; needs a CUDA device, nvcc and
cuobjdump.

The count is a diagnostic of one compilation, not a bound of the function
(chip_smoke.py bounds K1 by the operations its algorithm needs). Where no
kernel profiler is at hand it counts from the machine code: ``cuobjdump
-sass`` of the library, the step loop (the instructions from the target of
the widest backward branch of the kernel to that branch: one Philox block
and four steps) and of that span the fast path: a forward branch is
followed when the block it jumps over is a slow path, that is a leaf block
(no nested convergence region) that calls a subroutine or touches local
memory; every other conditional branch falls through. The schedulers need

    instructions per step x B x T / 32 / (SMs x 4 schedulers x SM clock).

`--errors` prints the error table instead. The draw path: Box-Muller over
2^22 blocks of random bits plus every uniform within 16 ulps of 1 and of 0
in the radius' and in the angle's place, the largest and the mean absolute
error of z against the twin's formulas evaluated in float64, for the
kernel's path on the special-function units, for the same formulas with
IEEE logf, sqrtf and sincosf, and for the float32 twin. The main path: stock and reward after one call
against the same rollout in float64, for the kernel and the float32 twin
(with `--root`, a parent's kernel gives the IEEE path's).

`--models` times the other configurations (the six growth models and the
mixture, lognormal noise, observation noise, the proportional and relative
schemes, drift: chip_smoke.py's parity cases, from a seed at B = 2^21, T =
512) and holds each against the twin at the parity size under chip_smoke's
bars, from planes and from a seed: as shipped, and built with the other
arithmetic (the source's K1_IEEE macro set against its default: IEEE draws
and functions under the continuous scheme, which ships with the cheaper
ones, and the cheaper ones under the proportional and relative schemes,
which ship with IEEE).
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent.parent
B, T, WARMUP = 1 << 21, 512, 5
STEPS_PER_LOOP = 4   # one Philox block feeds four steps
SCHEDULERS = 4       # warp schedulers per SM, one instruction each per clock
EDGE_ULPS = 16


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


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def median_ms(fn, reps: int) -> float:
    """Median device milliseconds of `reps` calls of `fn`, each between its
    own pair of CUDA events, after WARMUP calls. The calls are queued behind
    a device-side wait of ~30 ms, so that a launch of a few microseconds
    times the card and not the host that prepares the next one."""
    for _ in range(WARMUP):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda._sleep(60_000_000)   # SM clocks
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([start.elapsed_time(end) for start, end in pairs]))


def kernel_resources(log: str, kernel: str = "rollout_kernel"):
    """(registers, spill stores + loads in bytes) of `kernel` in nvcc's
    ``-Xptxas -v`` output."""
    regs, spills, inside = None, 0, False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            inside = kernel in line and "philox" not in line
        if inside:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spills = int(m.group(1)) + int(m.group(2))
    return regs, spills


def instruction_count(rk, _build, sass_out):
    """The shipped fishing-v1 library's step loop, from its machine code."""
    so = _build.library_path("rollout_kernel", rk.DEFAULT_CONFIGURATION.defines())
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    loop = step_loop(sass)
    if sass_out:
        Path(sass_out).parent.mkdir(parents=True, exist_ok=True)
        Path(sass_out).write_text("\n".join(f"{a:05x}  {t}" for a, t in loop) + "\n")
    fast = fast_path(loop)
    regs, spills = kernel_resources(_build.build_log.get(so.name, ""))
    return {"loop_instructions": len(loop), "fast_path_instructions": len(fast),
            "instructions_per_step": len(fast) / STEPS_PER_LOOP,
            "mix": dict(collections.Counter(opcode(t) for _, t in fast).most_common()),
            "registers": regs, "spill_bytes": spills}


def occupancy(regs: int, threads: int, sms: int):
    """(CTAs an SM holds, waves at B envs) from the registers a thread takes:
    65536 registers an SM, allocated per warp in units of 256, at most 2048
    threads and 32 CTAs."""
    per_warp = -(-regs * 32 // 256) * 256
    ctas = min(65536 // (per_warp * threads // 32), 2048 // threads, 32)
    return ctas, -(-B // threads) / (ctas * sms)


def edge_bits(rng):
    """(4, n) uint32 values as int64: 2^22 random Philox-like blocks, then
    every uniform within EDGE_ULPS of 1 (mantissa field k = 0...) and of 0
    (k = 2^23 - 1 ...) in the radius' place, in the angle's, and in both,
    each beside 64 random partners. Returns (bits, number of edge columns)."""
    ks = np.concatenate([np.arange(EDGE_ULPS + 1), (1 << 23) - 1 - np.arange(EDGE_ULPS + 1)])
    edge = np.repeat(ks.astype(np.int64) << 9, 64)       # the low 9 bits are dropped anyway
    m = edge.size
    cols = []
    for place in ("radius", "angle", "both"):
        c = rng.integers(0, 1 << 32, (4, m), dtype=np.int64)
        if place in ("radius", "both"):
            c[0], c[2] = edge, edge[::-1]
        if place in ("angle", "both"):
            c[1], c[3] = edge, edge[::-1]
        cols.append(c)
    cols.append(rng.integers(0, 1 << 32, (4, 1 << 22), dtype=np.int64))
    return np.concatenate(cols, axis=1), 3 * m


def box_muller_float64(rk, bits):
    """The twin's Box-Muller of the four uint32 tensors `bits` (held in
    int64) with every float in float64: the yardstick the draw paths are
    measured against. The uniforms themselves are exact in float32."""
    u = [rk._uniform_from_bits(b).double() for b in bits]
    rad0, rad1 = torch.sqrt(-2.0 * torch.log(u[0])), torch.sqrt(-2.0 * torch.log(u[2]))
    th0, th1 = 2.0 * np.pi * u[1], 2.0 * np.pi * u[3]
    return rad0 * torch.cos(th0), rad0 * torch.sin(th0), rad1 * torch.cos(th1), rad1 * torch.sin(th1)


def draw_errors(rk, dev):
    bits_np, n_edge = edge_bits(np.random.default_rng(2026))
    bits = torch.from_numpy(bits_np).to(dev)
    exact = torch.stack(box_muller_float64(rk, tuple(bits)))

    def row(z):
        err = (z.double() - exact).abs()
        return {"nan": int(torch.isnan(z).sum()), "max": float(err.max()),
                "mean": float(err.mean()), "max_edge": float(err[:, :n_edge].max())}

    return {"blocks": bits.shape[1], "edge_blocks": n_edge,
            "sfu": row(rk.normals_from_bits(bits, "sfu")),
            "ieee": row(rk.normals_from_bits(bits, "ieee")),
            "twin_float32": row(torch.stack(rk._box_muller_reference(tuple(bits))))}


def fishing_v1_float64(rk, params, x_star, stock, seed):
    """The main path's rollout (logistic, escapement, continuous, additive
    noise from Philox) with every float in float64: (stock, reward)."""
    f = lambda name: float(np.float32(float(getattr(params, name))))  # noqa: E731
    r, K, sigma, price, cost = f("r"), f("K"), f("sigma"), f("price"), f("cost")
    pen, init, tmax = f("collapse_penalty"), f("init_state"), int(params.Tmax)
    xs = float(np.float32(x_star))
    x = stock.double()
    t = torch.zeros_like(stock, dtype=torch.int32)
    rew = torch.zeros_like(x)
    idx = torch.arange(stock.shape[0], dtype=torch.int64, device=stock.device)
    zero = torch.zeros_like(idx)
    for k in range(T):
        if k % 4 == 0:
            bits = rk._philox4x32_10((idx, zero, zero + k // 4, zero),
                                     (seed & 0xFFFFFFFF, seed >> 32))
            z4 = box_muller_float64(rk, bits)
        quota = (x - xs).clamp_min(0.0)
        hv = torch.minimum(x, quota)
        x1 = x - hv
        x2 = x1 + r * x1 * (1.0 - x1 / K) + sigma * x1 * z4[k % 4]
        x_next = torch.where(x2 < 0.0, torch.zeros_like(x2), x2)
        collapsed = x_next <= 0.0
        rew = rew + price * hv - cost * quota * quota - pen * collapsed.double()
        t = t + 1
        done = (t >= tmax) | collapsed
        x = torch.where(done, torch.full_like(x, init), x_next)
        t = torch.where(done, torch.zeros_like(t), t)
    return x, rew


def main_path_errors(rk, run, params, x_star, stock, t0, seed):
    out = run()
    twin = rk.rollout_reference(stock, t0, params, "escapement", x_star, T, seed=seed)
    x64, rew64 = fishing_v1_float64(rk, params, x_star, stock, seed)
    table = {}
    for name, res in (("kernel", out), ("twin_float32", twin)):
        for field, exact in (("stock", x64), ("reward", rew64)):
            err = (getattr(res, field).double() - exact).abs()
            table[f"{name} {field}"] = {"max": float(err.max()), "mean": float(err.mean())}
    return table


def other_arithmetic(rk):
    """`rk.library`, but every configuration built with K1_IEEE set against
    its default."""
    return lambda config=rk.DEFAULT_CONFIGURATION: rk._library(
        config, (f"K1_IEEE={int(config.scheme == 0)}",))


def models(rk, dev, reps):
    """Every parity case of chip_smoke.py: its time from a seed at B, T, and
    its largest error against the twin at the parity size, from planes and
    from a seed, as shipped and with the other arithmetic."""
    import chip_smoke as cs
    import gym_fishing_tpu_torch as gtt

    n, tp = cs.B_PARITY, cs.T_PARITY
    rows = {}
    cases = cs.parity_cases(gtt)
    shipped_library = rk.library
    try:
        for variant in ("shipped", "other arithmetic"):
            if variant != "shipped":
                rk.library = other_arithmetic(rk)
            rk.build(rk.configuration(env.config.growth, int(params.model_idx),
                                      env.config.noise_form, policy, env.config.scheme,
                                      obs_noise, planes, float(params.r_drift))
                     for _, env, params, policy, _, obs_noise, _ in cases for planes in (0, 1))
            for index, case in enumerate(cases):
                rows[f"{case[0]} {variant}"] = model_row(rk, cs, dev, reps, index, case, n, tp)
    finally:
        rk.library = shipped_library
    return rows


def model_row(rk, cs, dev, reps, index, case, n, tp):
    _, env, params, policy, param, obs_noise, floor = case
    cfg = env.config
    rng = np.random.default_rng([2026, index])   # a case's data, whatever the variant
    kw = dict(growth=cfg.growth, noise_form=cfg.noise_form, scheme=cfg.scheme,
              n_actions=cfg.n_actions, obs_noise=obs_noise)
    stock = torch.from_numpy(rng.uniform(floor, 1.2, n).astype(np.float32)).to(dev)
    t = torch.from_numpy(rng.integers(0, int(params.Tmax), n).astype(np.int32)).to(dev)
    noise = torch.from_numpy(rng.standard_normal(
        (2 if obs_noise else 1, tp, n)).astype(np.float32)).to(dev)
    row = {}
    for source, more in (("planes", dict(noise=noise)), ("seed", dict(seed=7))):
        ker = rk.rollout(stock, t, params, policy, param, tp, **kw, **more)
        ref = rk.rollout_reference(stock, t, params, policy, param, tp, **kw, **more)
        row[source] = {
            "stock": cs.max_err(ker.stock, ref.stock),
            "reward": cs.max_err(ker.reward, ref.reward),
            "ep_ret_sum": cs.max_err(ker.ep_ret_sum, ref.ep_ret_sum),
            "t_or_count_differ": int((ker.t != ref.t).sum()
                                     + (ker.ep_count != ref.ep_count).sum())}
        row[source]["within_bars"] = bool(
            row[source]["stock"] <= cs.STOCK_ATOL
            and max(row[source]["reward"], row[source]["ep_ret_sum"]) <= cs.REWARD_ATOL
            and row[source]["t_or_count_differ"] == 0)
    big = torch.from_numpy(rng.uniform(floor, 1.2, B).astype(np.float32)).to(dev)
    t_big = torch.zeros(B, dtype=torch.int32, device=dev)
    row["ms"] = median_ms(lambda: rk.rollout(big, t_big, params, policy, param, T, seed=7, **kw),
                          reps)
    row["sm_clock"] = smi("clocks.sm")
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass-out", default=None, help="write the step loop's listing here")
    ap.add_argument("--errors", action="store_true")
    ap.add_argument("--models", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("rollout_instructions: needs a CUDA device")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import gym_fishing_tpu_torch as gtt
    from gym_fishing_tpu_torch.agents.policies import escapement
    from gym_fishing_tpu_torch.kernels import _build
    from gym_fishing_tpu_torch.kernels import rollout_kernel as rk

    dev = torch.device("cuda", 0)
    seed = 2026
    env, params = gtt.make("fishing-v1", sigma=0.05, device="cpu")  # K1 reads them on the host
    x_star = float(escapement(env, params).x_star)
    stock = torch.full((B,), float(params.init_state), dtype=torch.float32, device=dev)
    t0 = torch.zeros(B, dtype=torch.int32, device=dev)
    run = lambda: rk.rollout(stock, t0, params, "escapement", x_star, T, seed=seed)  # noqa: E731
    out = {"root": str(root), "card": smi("name,power.limit"), "B": B, "T": T,
           "reps": args.reps}
    per_configuration = hasattr(rk, "configuration")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    if args.errors:
        out["main_path"] = main_path_errors(rk, run, params, x_star, stock, t0, seed)
        if per_configuration:
            out["draw_path"] = draw_errors(rk, dev)
    elif args.models:
        out["models"] = models(rk, dev, args.reps)
    else:
        res = run()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(res.stock).all()):
            raise SystemExit("rollout_instructions: non-finite stock")
        out["ms"] = median_ms(run, args.reps)
        out["sm_clock_mhz"] = clock_mhz = float(smi("clocks.sm").split()[0])
        out["reward_sum"] = float(res.reward.double().sum())
        if per_configuration:
            count = instruction_count(rk, _build, args.sass_out)
            sched_ms = (count["instructions_per_step"] * B * T / 32
                        / (sms * SCHEDULERS * clock_mhz * 1e6) * 1e3)
            threads = rk.library().rollout_threads()
            ctas, waves = occupancy(count["registers"], threads, sms)
            out.update(count, sms=sms, threads_per_cta=threads, ctas_per_sm=ctas, waves=waves,
                       scheduler_ms=sched_ms, scheduler_share=sched_ms / out["ms"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
