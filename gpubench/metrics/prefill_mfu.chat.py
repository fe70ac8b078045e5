"""Model layer, chat cells: the extend replays' model operations (the
chunks' real rows) over their device time, as a share of the bf16 peak."""
from gpubench import reduce


def read(rec):
    return reduce.replays_mfu(rec, "extend")
