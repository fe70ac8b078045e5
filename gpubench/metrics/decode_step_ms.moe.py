"""Steps layer, a moe cell: the device time of a decode replay (the union
of its kernels' intervals between its two markers), the mean over the
traced slice; ``decode_step_ms``'s reading, for a step whose bytes are
mostly expert weights."""
from gpubench import reduce


def read(rec):
    rs = reduce.replays(rec, "decode")
    return sum(reduce.busy_us(r) for r in rs) / len(rs) / 1e3 if rs else None
