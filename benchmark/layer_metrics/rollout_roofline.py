"""The rollout's least time (roofline.rollout_bound) over the device time
of what the program launches inside its `train_step/rollout` range, per
traced iteration, in percent."""

from roofline import share_pct
from window import per_unit_ms


def read(record):
    f = record["facts"]
    return share_pct(f["rollout_least_ms"], per_unit_ms(record, f["ranges"]["rollout"]))
