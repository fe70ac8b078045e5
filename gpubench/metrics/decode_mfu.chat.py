"""Model layer, chat cells: the decode replays' model operations (active
slots only) over their device time, as a share of the bf16 peak."""
from gpubench import reduce


def read(rec):
    return reduce.replays_mfu(rec, "decode")
