"""The whole PPO step's share of the card's dense peak in the
configuration's precision: the step's model FLOPs (roofline.
ppo_iteration_flops) over the wall time of the window's untraced
iterations, in percent."""

from window import untraced


def read(record):
    units = untraced(record)
    seconds = sum(u[1] - u[0] for u in units)
    if not units or seconds <= 0:
        return None
    f = record["facts"]
    return 100.0 * f["flops_per_unit"] * len(units) / (seconds * f["peak_flops"])
