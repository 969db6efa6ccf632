"""The port of scripts/validate_kernel_rng.py
(gym_fishing_tpu_torch/validation/kernel_rng.py) on the CPU: its statistics,
a negative control of its independence check, and its exits without a card.
The checks themselves need the kernels' own draws and run on the card
(chip_smoke.py runs the module at its defaults)."""

import json

import numpy as np
import pytest
import torch
from scipy import stats

from gym_fishing_tpu_torch.validation import kernel_rng

torch.set_num_threads(1)


@pytest.mark.parametrize("n_a,n_b,shift", [(1000, 1000, 0.0), (4096, 777, 0.3), (50, 5000, -1.0)])
def test_ks_distance_is_scipys_statistic(n_a, n_b, shift):
    rng = np.random.default_rng(n_a + n_b)
    a, b = rng.standard_normal(n_a), rng.standard_normal(n_b) + shift
    assert kernel_rng.ks_distance(a, b) == pytest.approx(stats.ks_2samp(a, b).statistic,
                                                         abs=1e-12)


def test_ks_distance_counts_ties_as_the_empirical_cdf_does():
    a = np.array([0.0, 0.0, 1.0, 1.0])
    b = np.array([0.0, 1.0, 1.0, 1.0])
    assert kernel_rng.ks_distance(a, b) == pytest.approx(0.25)
    assert kernel_rng.ks_distance(a, b) == pytest.approx(stats.ks_2samp(a, b).statistic)


def test_compare_passes_one_distribution_and_fails_a_shift_or_a_scale():
    rng = np.random.default_rng(1)
    n = 1 << 17
    base = rng.standard_normal(n)
    checks = {}
    assert kernel_rng.compare("same", rng.standard_normal(n), base, checks)
    assert not kernel_rng.compare("shift", rng.standard_normal(n) + 0.05, base, checks)
    assert not kernel_rng.compare("scale", 1.08 * rng.standard_normal(n), base, checks)
    assert checks["same"]["ok"] and not checks["shift"]["ok"] and not checks["scale"]["ok"]
    assert checks["shift"]["mean_gap_se"] > 6 and checks["scale"]["std_ratio"] > 1.05


def test_block_independence_passes_independent_draws():
    checks = {}
    x = np.random.default_rng(2).standard_normal(1 << 17)
    assert kernel_rng.block_independence(x, checks)
    assert 0.5 < checks["block_independence"]["ratio"] < 1.5


def test_block_independence_fails_a_stream_replayed_over_a_blocks_lanes():
    """The negative control of check 3: one draw per block of 8 x 128 envs,
    replayed over all its lanes (a seed fold that ignores the lane), has the
    population's marginal but block means ~32 times too spread."""
    rng = np.random.default_rng(3)
    replayed = np.repeat(rng.standard_normal((1 << 17) // kernel_rng.BLOCK), kernel_rng.BLOCK)
    checks = {}
    assert not kernel_rng.block_independence(replayed, checks, name="replayed")
    assert checks["replayed"]["ratio"] > 20


def test_without_a_card_it_skips_and_never_runs_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_rng.main([]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["kernel_rng_validation"] == "SKIP"
    assert kernel_rng.main(["--require-cuda", "-B", "1024"]) == 2
    assert json.loads(capsys.readouterr().out)["kernel_rng_validation"] == "SKIP"
