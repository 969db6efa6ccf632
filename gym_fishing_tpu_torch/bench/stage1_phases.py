"""Where a chunk's time goes inside stage 1 of the fused PPO update kernels.

    python gym_fishing_tpu_torch/bench/stage1_phases.py

The card has no kernel profiler here, so this builds an instrumented copy of
``csrc/ppo_update_kernel.cu`` (into the gitignored ``_build/``): thread 0 of
every CTA reads ``clock64()`` after each block barrier of the chunk loop,
sums the cycles between barriers per phase, and writes the sums over the
first entries of its db1c partial, where stage 2 adds them up over the
CTAs. The gradients of that copy are therefore wrong, and nothing else uses
it. One minibatch of 128 random tiles of 2048 samples at hidden 64, as in
`update_kernels.py`; prints, per compute mode, the cycles per chunk of 64
samples between consecutive barriers in source order (float32 has one
barrier more than bfloat16, inside its last phase), averaged over the CTAs.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent.parent
N, TILE, MB_TILES, HIDDEN, SLOTS = 16384 * 128, 2048, 128, 64, 8


def instrument(source: str) -> str:
    """`source` with the clocks added to ppo_grad_tiles' chunk loop (the
    first; the wide path's is left as it is); raises if the loop is not
    found."""
    out, inside, n = [], False, 0
    for line in source.split("\n"):
        if line.startswith("  for (int chunk = c_begin;") and n == 0:
            out += [f"  long long ph[{SLOTS}] = {{0}};", line,
                    "    long long tprev = clock64(), tnow;"]
            inside = True
            continue
        if inside and line.startswith("  // This CTA's partial sums"):
            inside = False
        out.append(line)
        if inside and line.strip() == "__syncthreads();":
            out.append(f"    tnow = clock64(); ph[{min(n, SLOTS - 1)}] += tnow - tprev; "
                       "tprev = tnow;")
            n += 1
    store = "    out[L.b1 + tid] = zb1;\n"
    text = "\n".join(out)
    if n == 0 or text.count(store) != 1:
        raise RuntimeError("stage 1's chunk loop or its db1c store was not found")
    return text.replace(
        store, store + f"    if (tid < {SLOTS}) out[L.b1 + tid] = (float)ph[tid];\n")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("stage1_phases: needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    from gym_fishing_tpu_torch.agents import ppo, ppo_fused
    from gym_fishing_tpu_torch.kernels import _build
    from gym_fishing_tpu_torch.kernels import ppo_update_kernel as uk

    csrc = _build.BUILD_DIR / "phases_csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC, csrc)
    path = csrc / "ppo_update_kernel.cu"
    path.write_text(instrument(path.read_text()))
    _build.CSRC = csrc   # this process builds and loads the instrumented copy only

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)
    model = ppo.ActorCritic(1, 1, True, HIDDEN, generator=torch.Generator().manual_seed(3))
    weights = ppo_fused.kernel_weights(dict(model.named_parameters()), "gaussian")
    w_flat = uk.flatten_merged(uk.merge_weights(tuple(x.detach().to(dev) for x in weights)))
    rows = rng.standard_normal((uk.C_PAD, N)).astype(np.float32)
    rows[6:] = 0.0
    data = torch.from_numpy(rows).to(dev)
    order = torch.from_numpy(rng.permutation(N // TILE)[:MB_TILES].astype(np.int32)).to(dev)
    stats = torch.tensor([0.0, 1.0], device=dev)
    b1 = HIDDEN * 2   # offset of db1c in the flat buffer at obs_dim 1
    chunks = uk.stage1_rows(MB_TILES) * (TILE // uk.KERNEL_SPLIT // uk.KERNEL_CHUNK)
    out = {"card": torch.cuda.get_device_name(0)}
    for compute in uk.COMPUTES:
        scal = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.0, obs_dim=1, act_dim=1, tile=TILE,
                    head="gaussian", compute=compute)
        for _ in range(3):
            gout = uk._launch(data, order, w_flat, stats, HIDDEN, **scal)
        torch.cuda.synchronize()
        cycles = (gout[b1:b1 + SLOTS].double() / chunks).round().long().tolist()
        out[compute] = {"cycles_per_chunk_between_barriers": cycles, "total": sum(cycles)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
