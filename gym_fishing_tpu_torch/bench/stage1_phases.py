"""Where a chunk's time goes inside stage 1 of the fused PPO update kernels.

    python gym_fishing_tpu_torch/bench/stage1_phases.py [--root DIR] [--hidden H]
                                                       [--n-actions A]

The card has no kernel profiler here, so this builds an instrumented copy of
``csrc/ppo_update_kernel.cu`` (into the gitignored ``_build/``): thread i < 10
of every CTA reads ``clock64()`` after each block barrier of the chunk loop
of each stage-1 kernel (``ppo_grad_tiles``, ``ppo_grad_wide`` and, where the
source has it, ``ppo_grad_tower``), sums the cycles between barriers per
phase, and writes the sum of phase i over entry i of its db1c partial (the
tower kernel's value CTAs over entry H + i), where stage 2 adds them up over
the CTAs. The gradients of that copy are therefore wrong, and nothing else
uses it. One minibatch of 128 random tiles of 2048 samples, as in
`update_kernels.py`, at hidden `--hidden` (default 64) with the Gaussian
head or, with `--n-actions`, the categorical head of A classes; prints, per
compute mode, which kernel ran and the cycles per chunk between consecutive
barriers in source order, averaged over the CTAs (per tower for the tower
kernel). A chunk is 64 samples on the narrow path and 32 on the wide one.
`--root` names the checkout whose sources are instrumented and built, so the
parent's kernels can be clocked with this script. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent.parent
N, TILE, MB_TILES, SLOTS = 16384 * 128, 2048, 128, 10
WIDE_CHUNK = 32   # kWideChunk: samples per chunk of the wide and tower kernels
# kernel: the line that ends its chunk loop's region
KERNELS = {
    "ppo_grad_tiles": "  // This CTA's partial sums",
    "ppo_grad_wide": "  // the register sums into the row",
    "ppo_grad_tower": "  // the register sums into the row",
}
# the kernel's store of its db1c sums: out[L.b1 + tid] = zb1; row[L.b1 + tid]
# = (float)acc_b1; or column_sums(acc_b1, row + L.b1 + c0), which stores
# row[L.b1 + c0 + tid]
_STORE = re.compile(r"^(\s*)(?:(\w+)\[L\.b1 \+ ([^\]]+)\] = (?:\(float\)acc_b1|zb1)"
                    r"|column_sums\(acc_b1, (\w+) \+ L\.b1 \+ ([^)]+)\));$")


def instrument(source: str, kernel: str = "ppo_grad_tiles") -> str:
    """`source` with the clocks added to `kernel`'s chunk loop (the other
    kernels are left as they are); raises if the loop or its db1c store is
    not found."""
    lines = source.split("\n")
    start = next((i for i, line in enumerate(lines)
                  if line.strip().startswith(f"{kernel}(") and "__global__" in lines[i - 1]),
                 None)
    out, n, state, stored = [], 0, "before", False
    for i, line in enumerate(lines):
        if state == "before" and start is not None and i > start and line.startswith(
                "  for (int chunk = "):
            out += [f"  long long ph[{SLOTS}] = {{0}};", line,
                    "    long long tprev = clock64(), tnow;"]
            state = "inside"
            continue
        if state == "inside" and line.startswith(KERNELS[kernel]):
            state = "after"
        out.append(line)
        if state == "inside" and line.strip() == "__syncthreads();":
            out.append(f"    tnow = clock64(); ph[{min(n, SLOTS - 1)}] += tnow - tprev; "
                       "tprev = tnow;")
            n += 1
        m = _STORE.match(line) if state == "after" and not stored else None
        if m:
            arr, idx = (m[2], m[3]) if m[2] else (m[4], f"{m[5]} + tid")
            out.append(f"{m[1]}if (tid < {SLOTS}) {arr}[L.b1 + {idx}] = (float)ph[tid];")
            stored = True
    if n == 0 or not stored:
        raise RuntimeError(f"{kernel}'s chunk loop or its db1c store was not found")
    return "\n".join(out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--n-actions", type=int, default=0,
                    help="categorical head of this many classes (default: Gaussian)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stage1_phases: needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from gym_fishing_tpu_torch.agents import ppo, ppo_fused
    from gym_fishing_tpu_torch.kernels import _build
    from gym_fishing_tpu_torch.kernels import ppo_update_kernel as uk

    csrc = _build.BUILD_DIR / "phases_csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC, csrc)
    path = csrc / "ppo_update_kernel.cu"
    text = path.read_text()
    for kernel in KERNELS:
        if f"{kernel}(" in text:
            text = instrument(text, kernel)
    path.write_text(text)
    _build.CSRC = csrc   # this process builds and loads the instrumented copy only

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)
    gauss, hidden = args.n_actions == 0, args.hidden
    head, a = ("gaussian", 1) if gauss else ("categorical", args.n_actions)
    model = ppo.ActorCritic(1, a, gauss, hidden, generator=torch.Generator().manual_seed(3))
    weights = ppo_fused.kernel_weights(dict(model.named_parameters()), head)
    w_flat = uk.flatten_merged(uk.merge_weights(tuple(x.detach().to(dev) for x in weights)))
    rows = rng.standard_normal((uk.C_PAD, N)).astype(np.float32)
    if not gauss:   # the action row holds the class index
        rows[1] = rng.integers(0, a, N)
    rows[6:] = 0.0
    data = torch.from_numpy(rows).to(dev)
    order = torch.from_numpy(rng.permutation(N // TILE)[:MB_TILES].astype(np.int32)).to(dev)
    stats = torch.tensor([0.0, 1.0], device=dev)
    b1 = hidden * 2   # offset of db1c in the flat buffer at obs_dim 1
    lib = uk.library()
    out = {"card": torch.cuda.get_device_name(0), "root": os.path.abspath(args.root),
           "hidden": hidden, "head": head, "act_dim": a}
    for ci, compute in enumerate(uk.COMPUTES):
        scal = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.0, obs_dim=1, act_dim=a, tile=TILE,
                    head=head, compute=compute)
        for _ in range(3):
            gout = uk._launch(data, order, w_flat, stats, hidden, **scal)
        torch.cuda.synchronize()

        def per_chunk(col, chunks):
            return (gout[col:col + SLOTS].double() / chunks).round().long().tolist()

        tower = getattr(lib, "ppo_grad_tower_path", None)
        if not uk.wide_path(hidden, a):
            chunks = uk.stage1_rows(MB_TILES) * (TILE // uk.KERNEL_SPLIT // uk.KERNEL_CHUNK)
            res = {"kernel": "ppo_grad_tiles", "cycles_per_chunk": per_chunk(b1, chunks)}
        elif tower is not None and tower(hidden, a, ci):
            chunks = MB_TILES * (TILE // WIDE_CHUNK)
            res = {"kernel": "ppo_grad_tower", "policy": per_chunk(b1, chunks),
                   "value": per_chunk(b1 + hidden, chunks)}
        else:
            chunks = uk.stage1_rows(MB_TILES) * (TILE // uk.KERNEL_SPLIT // WIDE_CHUNK)
            res = {"kernel": "ppo_grad_wide", "cycles_per_chunk": per_chunk(b1, chunks)}
        for key in ("cycles_per_chunk", "policy", "value"):
            if key in res:
                res[f"{key}_total"] = sum(res[key])
        out[compute] = res
    print(json.dumps(out))


if __name__ == "__main__":
    main()
