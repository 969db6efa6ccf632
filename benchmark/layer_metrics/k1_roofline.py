"""K1's least time (roofline.rollout_kernel_bound) over the device time of
what the stepping call launches, per traced call, in percent."""

from roofline import share_pct
from window import per_unit_ms


def read(record):
    f = record["facts"]
    return share_pct(f["k1_least_ms"], per_unit_ms(record, f["ranges"]["k1"]))
