"""Kernels layer: ``flash_attention``'s share of its roofline in the traced
extend replays. Bound: the larger of the chunks' real rows' causal
operations over 989 TFLOP/s and their bytes over 3.35 TB/s."""
from gpubench import reduce


def read(rec):
    return reduce.attention_roofline(rec)
