"""The plain reference held against the port, the control and the planted
faults, each through the harness's own run (its look for a card skipped):
on the CPU at a size it runs in seconds, with the hidden width and every
other setting of the configuration kept; and on the card, where there is
one, at the cells' own sizes."""

import time

import pytest

import faults
import run as harness

CELLS = ("ppo-fishing-v1-h256.bf16", "sim-fishing-v1-escapement.batch2M")
SEED = 2 ** 31 + 4099


def _run(loaded, seed=SEED, device="cpu", seconds=0.05):
    doc, cell, config, traffic, driver = loaded
    result, checks = harness.execute(doc, cell, config, traffic, driver, seed, seconds, False,
                                        device, time.perf_counter())
    return result, checks


@pytest.mark.parametrize("name", CELLS)
def test_the_port_agrees_with_the_reference(tiny, name):
    result, checks = _run(tiny(name))
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_in_lower_precision_is_not_correct(tiny, name):
    _, _, config, traffic, driver = tiny(name)
    numbers = driver.control(config, traffic, SEED, "cpu")
    over = [k for k, lim in config["limits"].items() if numbers[k] > lim]
    assert over, numbers


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_under_the_timed_path_is_not_correct(tiny, name, fault):
    loaded = tiny(name)
    with faults.plant(loaded[2]["driver"], fault):
        result, checks = _run(loaded)
    assert not result["correct"], checks


def test_the_reference_philox_matches_the_stated_draws():
    """Philox4x32-10's published known-answer vector (Random123, kat_vectors:
    counter and key all ones)."""
    import torch

    from reference import philox
    ones = torch.full((1,), 0xFFFFFFFF, dtype=torch.int64)
    out = philox.philox4x32_10((ones, ones, ones, ones), (0xFFFFFFFF, 0xFFFFFFFF))
    assert [int(x) for x in out] == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_on_the_card_the_control_is_not_correct_on_three_seeds(card, name):
    _, _, config, traffic, driver = harness.load_cell(name)
    for seed in (3_100_000_007, 3_100_000_019, 3_100_000_031):
        numbers = driver.control(config, traffic, seed, card)
        assert any(numbers[k] > lim for k, lim in config["limits"].items()), (seed, numbers)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_on_the_card_the_port_is_correct(card, name):
    loaded = harness.load_cell(name)
    result, checks = _run(loaded, seed=3_200_000_011, device=card, seconds=1.0)
    assert result["correct"], checks
