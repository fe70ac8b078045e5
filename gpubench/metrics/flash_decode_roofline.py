"""Kernels layer, backlog cells: ``flash_decode``'s share of its roofline in
the traced decode replays. Bound: the bytes of the active slots' keys and
values, queries and outputs over 3.35 TB/s; time: ``decode_partial_kernel``
and ``decode_merge_kernel``."""
from gpubench import reduce


def read(rec):
    return reduce.decode_roofline(rec)
