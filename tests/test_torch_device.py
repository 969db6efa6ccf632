"""The port's default device, and the arithmetic and grid plan of the fused
PPO update kernels that a CPU can check.

- Entry points run on the card unless the caller asks for the CPU: without a
  device they raise on a machine with no card (never carrying on on the CPU),
  and with ``device="cpu"`` they work.
- `split3_matmul_reference` (three TF32 passes of split inputs) is as
  accurate as a float32 product against float64, and a single TF32 pass is
  not, so the two can be told apart.
- Stage 1's grid plan: `KERNEL_SPLIT` workspace rows per visited tile, tiles
  that are multiples of `KERNEL_CHUNK`, both as the CUDA source states them;
  and `bench/stage1_phases.py` still finds the chunk loop it instruments.
"""

import re

import numpy as np
import pytest
import torch

import gym_fishing_tpu_torch as gtt
from gym_fishing_tpu_torch import convert
from gym_fishing_tpu_torch.agents import ppo
from gym_fishing_tpu_torch.bench import measure, measure_ppo_train
from gym_fishing_tpu_torch.bench.stage1_phases import instrument
from gym_fishing_tpu_torch.device import resolve
from gym_fishing_tpu_torch.kernels import _build
from gym_fishing_tpu_torch.kernels import ppo_update_kernel as uk

torch.set_num_threads(1)

CFG = ppo.PPOConfig(num_envs=8, num_steps=4, num_minibatches=2, hidden=32)


def _env():
    return gtt.make("fishing-v1", device="cpu")[0]


def _flax_tree():
    model = ppo.ActorCritic(1, 1, True, 32, generator=torch.Generator().manual_seed(0))
    return convert.actor_critic_to_numpy(model)


def _param_fields():
    _, params = gtt.make("fishing-v1", device="cpu")
    return {k: np.asarray(v) for k, v in vars(params).items()}


def _batch_fields():
    z = np.zeros(4, np.float32)
    return dict(stock=z + 0.75, harvest=z, t=z.astype(np.int32), episode_return=z,
                episode_length=z.astype(np.int32))


# name -> a call of the entry point that takes the device (None: the default)
ENTRY_POINTS = {
    "make": lambda device: gtt.make("fishing-v1", device=device),
    "env_params": lambda device: _env().params(device=device),
    "make_train_state": lambda device: ppo.make_train_state(
        _env(), CFG, torch.Generator().manual_seed(0), device=device),
    "train": lambda device: ppo.train(_env(), CFG, iterations=1, device=device),
    "params_from_numpy": lambda device: convert.params_from_numpy(_param_fields(), device=device),
    "batch_state_from_numpy": lambda device: convert.batch_state_from_numpy(
        _batch_fields(), device=device),
    "actor_critic_from_numpy": lambda device: convert.actor_critic_from_numpy(
        _flax_tree(), device=device),
    "measure": lambda device: measure(mode="engine", num_envs=16, num_steps=2, iters=1,
                                      warmup=0, device=device),
    "measure_ppo_train": lambda device: measure_ppo_train(num_envs=16, num_steps=8, iters=1,
                                                          warmup=0, device=device),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_a_device_raises_when_there_is_no_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name](None)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_the_cpu_when_asked(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = ENTRY_POINTS[name]("cpu")
    tensors = []
    if name in ("make",):
        tensors = [out[1].K]
    elif name in ("env_params", "params_from_numpy"):
        tensors = [out.K]
    elif name == "make_train_state":
        tensors = list(out.model.parameters()) + list(out.m.values())
    elif name == "train":
        tensors = list(out[0].model.parameters())
        assert len(out[1]) == 1 and np.isfinite(out[1][0]["loss"])
    elif name == "batch_state_from_numpy":
        tensors = [out.env.stock, out.episode_length]
    elif name == "actor_critic_from_numpy":
        tensors = list(out.parameters())
    else:
        assert out["device"] == "cpu"
    assert all(t.device.type == "cpu" for t in tensors)


def test_resolve(monkeypatch):
    assert resolve("cpu") == torch.device("cpu")
    assert resolve(torch.device("cpu")) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:0", torch.device("cuda", 1)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            resolve(device)


def test_resolve_names_the_current_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert resolve(None) == torch.device("cuda", 3)
    assert resolve("cuda") == torch.device("cuda", 3)
    assert resolve("cuda:1") == torch.device("cuda", 1)


def test_fused_rollout_params_stay_on_the_host_in_words():
    """The two places that keep env params on the host say so: no None that
    would now mean the card."""
    for path in ("agents/ppo.py", "bench/throughput.py"):
        src = (_build.CSRC.parent / path).read_text()
        assert 'device="cpu" if' in src and "device=None if" not in src, path


# ------------------------------------------------ the split TF32 product

def test_tf32_round_is_round_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -23,
                      1.0 + 2.0 ** -11 - 2.0 ** -23, -1.0 - 2.0 ** -11, 3.0e-39, 0.0])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0, -1.0 - 2.0 ** -10,
                         3.0e-39, 0.0])
    got = uk.tf32_round(x)
    assert torch.equal(got[:5], want[:5]) and float(got[6]) == 0.0
    # 10 explicit mantissa bits survive: the 13 low bits are clear
    rng = np.random.default_rng(0)
    y = uk.tf32_round(torch.from_numpy(rng.standard_normal(4096).astype(np.float32)))
    assert int((y.view(torch.int32) & 0x1FFF).abs().max()) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split3_product_is_float32_accurate_and_one_pass_is_not(seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((256, 128)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32))
    exact = a.double() @ b.double()
    err32 = float((a @ b - exact).abs().max())
    err3 = float((uk.split3_matmul_reference(a, b) - exact).abs().max())
    err1 = float((uk.tf32_round(a) @ uk.tf32_round(b) - exact).abs().max())
    assert err3 <= 4 * err32
    assert err1 > 100 * err32


def test_split3_pieces_are_tf32_values_that_sum_back():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    hi = uk.tf32_round(a)
    lo = uk.tf32_round(a - hi)
    assert float(((hi + lo) - a).abs().max()) <= 2.0 ** -21 * float(a.abs().max())
    assert float(lo.abs().max()) <= 2.0 ** -11 * float(a.abs().max())


# --------------------------------------------------------- the grid plan

def _cuda_constant(name):
    src = (_build.CSRC / "ppo_update_kernel.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_grid_plan_matches_the_cuda_source():
    assert _cuda_constant("kChunk") == uk.KERNEL_CHUNK
    assert _cuda_constant("kSplit") == uk.KERNEL_SPLIT
    assert _cuda_constant("kThreads") == 512   # 16 warps a CTA


@pytest.mark.parametrize("num_tiles", [1, 32, 128])
def test_stage1_rows(num_tiles):
    assert uk.stage1_rows(num_tiles) == num_tiles * uk.KERNEL_SPLIT


@pytest.mark.parametrize("hidden,obs_dim,act_dim,tile,head,ok", [
    (64, 1, 1, 2048, "gaussian", True), (32, 4, 16, 64, "gaussian", True),
    (64, 1, 3, 128, "categorical", True), (128, 1, 1, 2048, "gaussian", True),
    (256, 4, 16, 2048, "gaussian", True), (256, 1, 128, 2048, "categorical", True),
    (32, 1, 100, 64, "categorical", True), (64, 5, 1, 2048, "gaussian", True),
    (64, 1, 1, 32, "gaussian", False), (64, 1, 1, 96, "gaussian", False),
    (48, 1, 1, 2048, "gaussian", False), (512, 1, 1, 2048, "gaussian", False),
    (64, 20, 1, 2048, "gaussian", False), (64, 1, 17, 2048, "gaussian", False),
    (256, 1, 129, 2048, "categorical", False),
])
def test_kernel_limits(hidden, obs_dim, act_dim, tile, head, ok):
    if ok:
        uk.check_kernel_limits(hidden, obs_dim, act_dim, tile, head=head)
    else:
        with pytest.raises(ValueError, match="the CUDA kernel takes"):
            uk.check_kernel_limits(hidden, obs_dim, act_dim, tile, head=head)


def test_phase_clocks_find_the_chunk_loop():
    """One clock read at the top of a chunk and one after each of its block
    barriers (5 under bfloat16 plus float32's own), and the sums stored over
    the db1c partial; a source without the loop is refused."""
    src = (_build.CSRC / "ppo_update_kernel.cu").read_text()
    out = instrument(src)
    assert out.count("clock64()") == 7
    assert out.count("(float)ph[tid]") == 1 and len(out) > len(src)
    with pytest.raises(RuntimeError, match="chunk loop"):
        instrument("__global__ void k() { __syncthreads(); }")


@pytest.mark.parametrize("kernel,barriers", [("ppo_grad_wide", 7), ("ppo_grad_tower", 9)])
def test_phase_clocks_find_the_wide_chunk_loops(kernel, barriers):
    """The wide path's chunk loops take the clocks too: one read at the top
    of a chunk and one after each of its barriers, the sums stored over the
    kernel's own db1c entries (the tower kernel's at its tower's columns),
    and no other kernel's loop touched."""
    src = (_build.CSRC / "ppo_update_kernel.cu").read_text()
    out = instrument(src, kernel)
    assert out.count("clock64()") == barriers + 1
    store = [line.strip() for line in out.split("\n") if "(float)ph[tid]" in line]
    index = "c0 + tid" if kernel == "ppo_grad_tower" else "tid"
    assert store == [f"if (tid < 10) row[L.b1 + {index}] = (float)ph[tid];"]
    assert instrument(out, "ppo_grad_tiles").count("clock64()") == barriers + 8
