"""Kernels layer, chat cells: ``flash_decode``'s share of its roofline, as
``flash_decode_roofline`` reads it. Here part of the slots are idle and
read their whole cache rows: that is time and not work."""
from gpubench import reduce


def read(rec):
    return reduce.decode_roofline(rec)
