"""The cell `ppo-fishing-v0-q100-h256.bf16` through the harness's own run
(its look for a card skipped): the port against the categorical reference,
the control and the faults planted under the timed path, on the CPU at a
size it runs in seconds to a minute (the hidden width, the 100 classes and
every other setting of the configuration kept), and on the card, where there is one,
at the cell's own size.

Faults, each a context manager that patches the program's module in place
and restores it on exit:

- `unchanged`: a train step that returns its state unchanged;
- `half_batch`: K3 given half of each minibatch's tiles, its metric sums
  scaled back up;
- `altered`: K3's minibatch metric sums 5% high;
- `far_class`: the rollout's recorded classes two classes above those
  drawn (the top class kept).
"""

import contextlib
import copy
import time

import pytest

import faults
import run as harness

CELL = "ppo-fishing-v0-q100-h256.bf16"
SEED = 2 ** 31 + 4099
TINY = {"num_envs": 512, "num_steps": 64}
# a share of 2^17 draws: at TINY's 2^15 one flipped draw (3.1e-5) is over the
# limit that `actions_differ` takes over the cell's 2^21
AGREE = {"num_envs": 1024, "num_steps": 128}
FAULTS = ("unchanged", "half_batch", "altered", "far_class")


@contextlib.contextmanager
def plant(fault: str):
    from gym_fishing_tpu_torch.agents import ppo, ppo_fused

    if fault == "unchanged":
        def wrap(step):
            def train_step(env, env_params, cfg, ts, bstate, *a, **kw):
                _, _, metrics = step(env, env_params, cfg, copy.deepcopy(ts), bstate, *a, **kw)
                return ts, bstate, metrics
            return train_step
        module, name = ppo, "train_step"
    elif fault in ("half_batch", "altered"):
        def wrap(kernel):
            def fused_minibatch_grad_adam(data, tile_order, *a, **kw):
                if fault == "altered":
                    w, m, v, met = kernel(data, tile_order, *a, **kw)
                    return w, m, v, met * 1.05
                half = max(1, tile_order.shape[0] // 2)
                w, m, v, met = kernel(data, tile_order[:half], *a, **kw)
                return w, m, v, met * (tile_order.shape[0] / half)
            return fused_minibatch_grad_adam
        module, name = ppo_fused, "fused_minibatch_grad_adam"
    elif fault == "far_class":
        def wrap(collect):
            def fused_rollout_collect(env, *a, **kw):
                roll, bstate = collect(env, *a, **kw)
                top = float(env.config.n_actions - 1)
                roll.packed_t[1] = (roll.packed_t[1] + 2.0).clamp(max=top)
                return roll, bstate
            return fused_rollout_collect
        module, name = ppo_fused, "fused_rollout_collect"
    else:
        raise ValueError(f"no such fault: {fault!r}")
    with faults._patched(module, name, wrap):
        yield


def _loaded(size=None):
    doc, cell, config, traffic, driver = harness.load_cell(CELL)
    if size:
        config["ppo"].update(size)
    return doc, cell, config, traffic, driver


def _run(loaded, seed=SEED, device="cpu", seconds=0.05):
    doc, cell, config, traffic, driver = loaded
    return harness.execute(doc, cell, config, traffic, driver, seed, seconds, False, device,
                           time.perf_counter())


def test_the_port_agrees_with_the_categorical_reference():
    result, checks = _run(_loaded(AGREE))
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    numbers = dict((k, v) for k, v, _ in checks)
    assert numbers["actions_far"] == 0 and numbers["off_path"] == 0


def test_the_control_in_lower_precision_is_not_correct():
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


def test_the_cell_bounds_its_metrics_by_the_categorical_head():
    """The roofline shares divide by the categorical bounds: K3's 101-wide
    head costs more than the Gaussian one, and K4's sampler more again."""
    import roofline
    _, _, config, _, driver = _loaded()
    _, _, gauss_config, _, gauss_driver = harness.load_cell("ppo-fishing-v1-h256.bf16")
    f, g = driver.facts(config), gauss_driver.facts(gauss_config)
    n_par = roofline.merged_params(1, 256, 100)
    upd, _ = roofline.update_bound(2 ** 18, 1, 256, 100, "bfloat16", head="categorical",
                                   extra_bytes=roofline.clip_adam_bytes(n_par))
    assert f["update_least_ms"] == pytest.approx(32 * upd)
    assert f["update_least_ms"] > g["update_least_ms"]
    assert f["rollout_least_ms"] > g["rollout_least_ms"]
    assert f["flops_per_unit"] > g["flops_per_unit"]


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
