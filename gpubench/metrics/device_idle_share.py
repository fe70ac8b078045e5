"""Device layer, backlog cells: the share of the traced slice in which no
operation ran on the card."""
from gpubench import reduce


def read(rec):
    return reduce.idle_share(rec)
