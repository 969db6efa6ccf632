"""The yardstick's figures at the cells' shapes, and shares that never pass
100% for a time at or above the bound."""

import pytest

import roofline


def test_update_bound_at_the_ppo_cell():
    ms, by = roofline.update_bound(2 ** 18, 1, 256, 1, "bfloat16")
    assert by == "operations"
    assert round(ms, 4) == 0.2085


def test_rollout_bound_at_the_ppo_cell():
    ms, by = roofline.rollout_bound(16384, 128, 1, 256, 1, "bfloat16")
    assert by == "operations"
    assert round(ms, 4) == 0.5580


def test_rollout_kernel_bound_at_the_stepping_cell():
    ms, by = roofline.rollout_kernel_bound(2 ** 21, 512)
    assert by == "operations"
    assert round(ms, 4) == 1.2838


def test_clip_adam_is_bound_by_bytes():
    n_par = roofline.merged_params(1, 256, 1)
    assert n_par == 264707
    ms, by = roofline.clip_adam_bound(n_par)
    assert by == "bytes"
    assert ms == pytest.approx(28 * n_par / 3.35e12 * 1e3)


def test_optimizer_bytes_do_not_change_the_update_bound_at_256():
    base, _ = roofline.update_bound(2 ** 18, 1, 256, 1, "bfloat16")
    more, _ = roofline.update_bound(2 ** 18, 1, 256, 1, "bfloat16",
                                    extra_bytes=roofline.clip_adam_bytes(264707))
    assert more == base


def test_iteration_flops():
    assert roofline.ppo_iteration_flops(16384, 128, 4, 1, 256, 1) == pytest.approx(7.2027e12,
                                                                                    rel=1e-4)


@pytest.mark.parametrize("least", [0.2085, 0.558, 1.2838, 6.67])
@pytest.mark.parametrize("factor", [1.0, 1.0001, 3.0, 1000.0])
def test_share_stays_at_or_below_100(least, factor):
    assert roofline.share_pct(least, least * factor) <= 100.0


def test_share_of_nothing_is_none():
    assert roofline.share_pct(1.0, 0.0) is None
    assert roofline.share_pct(1.0, None) is None


def test_mfu_stays_at_or_below_100_for_a_time_at_the_peak():
    import window  # noqa: F401
    from importlib import util
    from pathlib import Path
    path = Path(roofline.__file__).parent / "layer_metrics" / "train.mfu.py"
    spec = util.spec_from_file_location("train_mfu", path)
    mod = util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    flops = roofline.ppo_iteration_flops(16384, 128, 4, 1, 256, 1)
    least_s = flops / roofline.PEAK["bfloat16"]
    for factor in (1.0, 2.0, 14.0):
        record = {"units": [[0.0, least_s * factor, 1, 0]] * 3, "traced": (0, 0),
                  "facts": {"flops_per_unit": flops, "peak_flops": roofline.PEAK["bfloat16"]}}
        assert mod.read(record) <= 100.0 + 1e-9
