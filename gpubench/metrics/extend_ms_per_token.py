"""Steps layer: the device time of the traced extend replays over the real
tokens of their chunks (a chunk's padding is time, not work)."""
from gpubench import reduce


def read(rec):
    rs = reduce.replays(rec, "extend")
    tokens = sum(r["c"] for r in rs)
    return sum(reduce.busy_us(r) for r in rs) / 1e3 / tokens if tokens else None
