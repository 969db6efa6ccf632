"""The update's least time (epochs x minibatches x roofline.update_bound,
with the optimizer's bytes) over the device time of what the program
launches inside its `train_step/update` range, per traced iteration, in
percent."""

from roofline import share_pct
from window import per_unit_ms


def read(record):
    f = record["facts"]
    return share_pct(f["update_least_ms"], per_unit_ms(record, f["ranges"]["update"]))
