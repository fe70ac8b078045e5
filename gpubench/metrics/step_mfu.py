"""Model layer: the model's operations on every token that the traced
slice's replays processed (2 x the product weights it meets, the
unembedding only where logits are wanted, causal attention) over the
slice's serving time, as a share of the 989 TFLOP/s bf16 peak."""
from gpubench import reduce


def read(rec):
    return reduce.step_mfu(rec)
